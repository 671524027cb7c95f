"""Probe of the RMSNorm forward and backward kernels on one NVIDIA card: how
far each output is from its plain version, the device time of each kernel
beside its bytes bound and PyTorch's own fused RMSNorm, and, with `--against
DIR` (repeatable), the same for other versions of `csrc/rms.cu` in the same
process (each built from a DIR holding that version's `rms.cu` and
`common.cuh`, labelled by the directory two levels above it; its partial-row
count is read from `DIR/../ops/rms.py`).

Each library is called through the C interface the wrappers use
(`ktwe_rms_norm_fwd`, `ktwe_rms_norm_bwd`), outputs allocated as the
wrappers allocate them. Device ms: 50 calls captured in one CUDA graph,
replayed 5 times between CUDA events (chip_smoke.py's `device_ms`), taken in
turns: the others, this, this, the others in reverse. Yardsticks:
`F.rms_norm` forward and the op its backward runs
(`aten._fused_rms_norm_backward`, dx and dw) on the same inputs with the
weight in x's dtype, taken alike; the backward also as eager
`torch.autograd.grad` calls between events (10 calls). A torch.profiler
split names each backward's kernel launches. What the card's memory reaches
for the same traffic: `copy_` of x (the forward's bytes) and `torch.add(x,
dy, out=)` (the backward's), taken alike. Cases: decode (8 rows) and prefill
(128 rows) at 2048 bf16 with a bf16 weight, the trainer's (16384, 2048) bf16
with an f32 weight, the f32 gate's (1024, 2048). One JSON line a case; exits
1 without a card. Imports torch and the port only.

    python3 scripts/rms_probe.py [--against OTHER_CHECKOUT/<package>/csrc ...]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12
BF16_TOL = 2e-2
BWD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
BWD_ATOL_OF_RMS = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
bf16, f32 = torch.bfloat16, torch.float32
FWD_CASES = ((8, 2048, bf16, bf16), (128, 2048, bf16, bf16),
             (16384, 2048, bf16, f32), (1024, 2048, f32, f32))
BWD_CASES = ((16384, 2048, bf16, f32), (1024, 2048, f32, f32))


def device_ms(fn, iters: int = 50, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return events_ms(lambda: [graph.replay() for _ in range(replays)],
                     warmup=0) / (iters * replays)


def events_ms(fn, iters: int = 1, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launches_ms(fn) -> dict:
    """Device ms of each kernel launch of one call of fn, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:70]
            out[name] = out.get(name, 0.0) + (e.time_range.end
                                              - e.time_range.start) / 1e3
    return out


class Lib:
    """One build of csrc/rms.cu behind its C interface."""

    def __init__(self, lib, parts: int, label: str):
        self.lib, self.parts, self.label = lib, parts, label

    def fwd(self, x, w, eps=1e-6):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        out = torch.empty_like(x)
        code = self.lib.ktwe_rms_norm_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], eps, kernels.DTYPE_CODES[x.dtype],
            kernels.DTYPE_CODES[w.dtype], 0, kernels.stream_handle(x))
        kernels.check(self.lib, f"{self.label} rms_norm", code)
        return out

    def bwd(self, x, w, dy, eps=1e-6):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        rows, d = x.shape
        parts = min(rows, self.parts)
        dx = torch.empty_like(x)
        partial = torch.empty((parts, d), dtype=f32, device=x.device)
        dw = torch.empty_like(w)
        code = self.lib.ktwe_rms_norm_bwd(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), rows, d, eps, parts,
            kernels.DTYPE_CODES[x.dtype], kernels.DTYPE_CODES[w.dtype], 0,
            kernels.stream_handle(x))
        kernels.check(self.lib, f"{self.label} rms_norm_bwd", code)
        return dx, dw


def bind(path: Path):
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in kernels.SIGNATURES["rms"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ktwe_error_string.argtypes = [ctypes.c_int]
    lib.ktwe_error_string.restype = ctypes.c_char_p
    return lib


def build_other(csrc: Path, label: str) -> tuple:
    """Build csrc/rms.cu of another version with the port's flags."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    h = hashlib.sha256()
    for part in (csrc / "rms.cu", csrc / "common.cuh"):
        h.update(part.read_bytes())
    out = kernels.BUILD_DIR / f"rms-{label}-{h.hexdigest()[:16]}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                           str(out), str(csrc / "rms.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{proc.stdout}"
                           f"{proc.stderr}")
    rms_py = (csrc.parent / "ops" / "rms.py").read_text()
    parts = int(re.search(r"^BWD_PARTS = (\d+)", rms_py, re.M).group(1))
    return bind(out), parts, proc.stdout + proc.stderr


def max_errors(got, want, atol, rtol):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return dict(max_abs_err=float(diff.max()),
                ok=bool((diff <= atol + rtol * w.abs()).all()))


def bwd_limits(got, want):
    rms_w = (float(torch.linalg.vector_norm(want, dtype=f32))
             / max(1, want.numel()) ** 0.5)
    return max_errors(got, want, BWD_ATOL_OF_RMS[want.dtype] * rms_w,
                      BWD_RTOL[want.dtype])


def in_turns(libs, fn) -> dict:
    """Device ms of fn(lib) for each library, in the order a, b, b, a."""
    order = libs + libs[::-1]
    times = {lib.label: [] for lib in libs}
    for lib in order:
        times[lib.label].append(device_ms(lambda: fn(lib)))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="csrc directory of another version to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rms_probe: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels, rms
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"build_s": kernels.build(["rms"])}), flush=True)
    print(kernels.build_log("rms"), flush=True)
    libs = []
    for csrc in args.against:
        label = csrc.resolve().parents[1].name
        lib, parts, log = build_other(csrc, label)
        print(f"== {label}\n{log}", flush=True)
        libs.append(Lib(lib, parts, label))
    libs.append(Lib(kernels.library("rms"), rms.BWD_PARTS, "this"))
    dev = torch.device("cuda", 0)
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for rows, d, dt, wdt in FWD_CASES:
        x = randn(rows, d, dtype=dt)
        w = (1.0 + 0.1 * randn(d, dtype=f32)).to(wdt)
        want = rms.rms_norm_plain(x, w)
        tol = BF16_TOL if dt == bf16 else 1e-5
        row = dict(kernel="rms_norm", shape=[rows, d],
                   dtype=str(dt).split(".")[-1],
                   w_dtype=str(wdt).split(".")[-1],
                   bound_ms=(2 * x.numel() * x.element_size()
                             + d * w.element_size()) / HBM_BYTES_PER_S * 1e3)
        for lib in libs:
            row[f"{lib.label}_errors"] = max_errors(lib.fwd(x, w), want,
                                                    tol, tol)
        row["ms"] = in_turns(libs, lambda lib: lib.fwd(x, w))
        wl = w.to(dt)
        row["library_ms"] = device_ms(lambda: F.rms_norm(x, (d,), wl, 1e-6))
        o = torch.empty_like(x)
        row["copy_ms"] = device_ms(lambda: o.copy_(x))
        print(json.dumps(row), flush=True)

    for rows, d, dt, wdt in BWD_CASES:
        x, dy = randn(rows, d, dtype=dt), randn(rows, d, dtype=dt)
        w = (1.0 + 0.1 * randn(d, dtype=f32)).to(wdt)
        want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
        row = dict(kernel="rms_norm_bwd", shape=[rows, d],
                   dtype=str(dt).split(".")[-1],
                   w_dtype=str(wdt).split(".")[-1],
                   bound_ms=(3 * x.numel() * x.element_size()
                             + 2 * d * w.element_size())
                   / HBM_BYTES_PER_S * 1e3)
        for lib in libs:
            dx, dw = lib.bwd(x, w, dy)
            row[f"{lib.label}_errors"] = dict(
                dx=bwd_limits(dx, want_dx), dw=bwd_limits(dw, want_dw),
                dw_bitwise_repeatable=bool(torch.equal(lib.bwd(x, w, dy)[1],
                                                       dw)))
        row["ms"] = in_turns(libs, lambda lib: lib.bwd(x, w, dy))
        row["launches_ms"] = {lib.label: launches_ms(lambda: lib.bwd(x, w, dy))
                              for lib in libs}
        o = torch.empty_like(x)
        row["add_ms"] = device_ms(lambda: torch.add(x, dy, out=o))
        wl = w.to(dt)
        _, rstd = torch.ops.aten._fused_rms_norm(x, [d], wl, 1e-6)
        row["library_ms"] = device_ms(
            lambda: torch.ops.aten._fused_rms_norm_backward(
                dy, x, [d], rstd, wl, [True, True]))
        xa, wa = x.detach().requires_grad_(), wl.detach().requires_grad_()
        out = F.rms_norm(xa, (d,), wa, 1e-6)
        row["library_eager_ms"] = events_ms(
            lambda: torch.autograd.grad(out, (xa, wa), dy, retain_graph=True),
            iters=10)
        row["library_launches_ms"] = launches_ms(
            lambda: torch.autograd.grad(out, (xa, wa), dy, retain_graph=True))
        print(json.dumps(row), flush=True)
        del x, dy, want_dx, out, xa
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
