"""Step-time telemetry of a training run.

Port of `StepStats` / `StepTimer` from
k8s_gpu_workload_enhancer_tpu/train/profiling.py for one card (its XLA
trace helpers and the telemetry sink that feeds the node agent are not
ported). The default peak is one H100 SXM's dense bf16 tensor-core
rate from NVIDIA's data sheet, 989 TFLOP/s, so `mfu_pct` is model FLOPs
utilization of that card.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List

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
