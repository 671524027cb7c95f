"""The port's trace helpers (train/profiling.py) on the CPU:
`device_duty_cycle` on a hand-written Chrome trace with overlapping
kernel, copy and memset intervals on two devices (an exact value, the
JAX function's per-device average over the common span), and None for a
torch.profiler trace of CPU work only, written by `trace` and by
`trace_steps` over the port's train step."""

import json
import os

import pytest
import torch

from k8s_gpu_workload_enhancer_tpu_torch.train import profiling
from k8s_gpu_workload_enhancer_tpu_torch.train import trainer

import torch_parity as tp


def _write(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def _x(cat, ts, dur, device, **kw):
    return {"ph": "X", "cat": cat, "name": kw.get("name", cat), "pid": device,
            "tid": kw.get("stream", 7), "ts": ts, "dur": dur,
            "args": {"device": device, "stream": kw.get("stream", 7)}}


def test_duty_cycle_of_a_hand_written_two_device_trace(tmp_path):
    """Device 0: kernels [0, 40) and [30, 60) overlap on two streams, a
    memcpy [70, 80): busy 70 of the span. Device 1: a memset [20, 30), a
    kernel [90, 100) and one [25, 28) inside the memset: busy 20. The span
    is [0, 100) over both devices, so (70 + 20) / 2 = 45 %. Host events,
    instant events and flow arrows do not count."""
    events = [
        _x("kernel", 0, 40, 0), _x("kernel", 30, 30, 0, stream=13),
        _x("gpu_memcpy", 70, 10, 0),
        _x("gpu_memset", 20, 10, 1), _x("kernel", 90, 10, 1),
        _x("kernel", 25, 3, 1, stream=9),
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242,
         "tid": 1, "ts": -500, "dur": 2000, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 1, "ts": 150, "dur": 5, "args": {}},
        {"ph": "i", "cat": "kernel", "name": "mark", "pid": 0, "ts": 500,
         "s": "t"},
        {"ph": "f", "cat": "ac2g", "id": 1, "pid": 0, "tid": 7, "ts": 1},
    ]
    _write(tmp_path / "trace-1.json", events)
    assert profiling.device_duty_cycle(str(tmp_path)) == pytest.approx(45.0)
    # The newest trace in the directory is the one read.
    _write(tmp_path / "trace-2.json", [_x("kernel", 0, 10, 0),
                                       _x("kernel", 15, 5, 0)])
    os.utime(tmp_path / "trace-2.json",
             (os.path.getmtime(tmp_path / "trace-1.json") + 5,) * 2)
    assert profiling.device_duty_cycle(str(tmp_path)) == pytest.approx(75.0)


def test_no_device_events_is_none(tmp_path):
    assert profiling.device_duty_cycle(str(tmp_path / "missing")) is None
    _write(tmp_path / "t.json", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1,
         "ts": 0, "dur": 10, "args": {}}])
    assert profiling.device_duty_cycle(str(tmp_path)) is None


def test_a_cpu_only_torch_profiler_trace_is_none(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("trace-") and name.endswith(".json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert profiling.device_duty_cycle(str(tmp_path)) is None
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        torch.randn(8, 8) @ torch.randn(8, 8)
    assert not os.path.exists(tmp_path / "off")


def test_trace_steps_profiles_the_train_step(tmp_path):
    """Two steps of the port's train step on the CPU under trace_steps:
    the state advances, each step is annotated in the Chrome trace, and
    with no device activity the duty cycle is None."""
    cfg = tp.train_torch_cfg()
    tcfg = trainer.TrainConfig(batch_size=2, seq_len=16, warmup_steps=1,
                               total_steps=4)
    state = trainer.init_state(cfg, tcfg, torch.Generator().manual_seed(0))
    step = trainer.make_train_step(cfg, tcfg)
    batches = trainer.synthetic_batches(cfg, tcfg, "cpu")
    state, metrics = profiling.trace_steps(step, state, batches,
                                           str(tmp_path), num_steps=2)
    assert state.step == 2 and metrics["step"] == 2
    assert torch.isfinite(metrics["loss"])
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train step 0", "train step 1"} <= names
    assert profiling.device_duty_cycle(str(tmp_path)) is None
