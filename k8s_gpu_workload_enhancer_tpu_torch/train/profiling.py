"""Step-time telemetry and device traces of a training run.

Port of k8s_gpu_workload_enhancer_tpu/train/profiling.py for one card:
`StepStats` / `StepTimer`, and the trace helpers `trace`, `trace_steps`
and `device_duty_cycle` on torch.profiler where the JAX package uses the
XLA profiler (the telemetry sink that feeds the node agent is not
ported). The default peak is one H100 SXM's dense bf16 tensor-core rate
from NVIDIA's data sheet, 989 TFLOP/s, so `mfu_pct` is model FLOPs
utilization of that card.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

H100_BF16_PEAK_TFLOPS = 989.0


@dataclass
class StepStats:
    step: int
    wall_s: float
    tokens: int = 0
    flops: float = 0.0


class StepTimer:
    """Measures per-step wall time and derives utilization telemetry. The
    caller ends each timed step with a host sync (reading the loss), so the
    wall time covers the device's work."""

    def __init__(self, peak_tflops: float = H100_BF16_PEAK_TFLOPS):
        self.peak_tflops = peak_tflops
        self.history: List[StepStats] = []

    @contextlib.contextmanager
    def step(self, step_num: int, tokens: int = 0, flops: float = 0.0):
        t0 = time.perf_counter()
        yield
        self.history.append(StepStats(step=step_num,
                                      wall_s=time.perf_counter() - t0,
                                      tokens=tokens, flops=flops))

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        hist = self.history[skip_warmup:] or self.history
        if not hist:
            return {}
        total_tokens = sum(s.tokens for s in hist)
        total_wall = sum(s.wall_s for s in hist)
        total_flops = sum(s.flops for s in hist)
        return {
            "steps": len(hist),
            "avg_step_s": total_wall / len(hist),
            "tokens_per_s": total_tokens / total_wall if total_wall else 0.0,
            "achieved_tflops": total_flops / total_wall / 1e12
            if total_wall else 0.0,
            "mfu_pct": min(100.0, 100.0 * (total_flops / total_wall / 1e12)
                           / self.peak_tflops) if total_wall and
            self.peak_tflops else 0.0,
        }


# The Chrome-trace categories of device activity in a torch.profiler
# export: kernels, copies and memsets.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the body with torch.profiler (host activity, and the card's
    where there is one) and export a Chrome trace (viewable in Perfetto or
    chrome://tracing) into `log_dir` as `trace-<ns>.json`."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def trace_steps(step_fn, state, batches, log_dir: str, num_steps: int = 3):
    """Profile `num_steps` train steps (each annotated `train step i`);
    the trace ends in a host read of the last loss, so it holds the
    device's work. Returns (state, metrics) of the last step."""
    metrics = None
    with trace(log_dir):
        for i, batch in zip(range(num_steps), batches):
            with torch.profiler.record_function(f"train step {i}"):
                state, metrics = step_fn(state, batch)
        if metrics is not None:
            float(metrics["loss"])          # waits for the device
    return state, metrics


def _busy(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    return busy


def device_duty_cycle(trace_dir: str) -> Optional[float]:
    """The device duty cycle in [0, 100] of the newest Chrome trace in
    `trace_dir` (`trace` writes one): per device, the union of its kernel,
    memcpy and memset intervals over the span from the first to the last
    device event of the trace, averaged over devices (per device, so that
    staggered devices are not reported as one busy device). The GPU
    counterpart of nvidia-smi's utilization, as opposed to MFU. None if
    the trace holds no device events."""
    paths = glob.glob(os.path.join(trace_dir, "*.json")) + glob.glob(
        os.path.join(trace_dir, "*.json.gz"))
    if not paths:
        return None
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    by_device: Dict[object, list] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                and "dur" in e):
            dev = e.get("args", {}).get("device", e.get("pid"))
            by_device.setdefault(dev, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not by_device:
        return None
    start = min(s for iv in by_device.values() for s, _ in iv)
    end = max(e for iv in by_device.values() for _, e in iv)
    if end <= start:
        return None
    cycles = [100.0 * _busy(iv) / (end - start) for iv in by_device.values()]
    return sum(cycles) / len(cycles)
