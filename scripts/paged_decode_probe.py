"""Probe of the paged decode kernels on one NVIDIA card: how far each output
is from the plain version, the device time beside the bytes bound and
`scaled_dot_product_attention` over the same rows laid out as a contiguous
cache (a yardstick: that call does no table walk), and how the time splits
between the split-KV kernel and its combine. With `--against DIR`
(repeatable), the same for other versions of `csrc/paged_decode.cu`, each
built from a DIR holding that version's `paged_decode.cu` and
`common.cuh` (labelled by the directory two levels above it) and called
through its own C interface: the split-KV one (`ktwe_paged_decode_split`,
`ktwe_paged_decode_combine`) or the first version's single launch
(`ktwe_paged_decode_fwd`).

Device ms: 50 calls captured in one CUDA graph, replayed 5 times between
CUDA events (chip_smoke.py's `device_ms`), taken in turns: the others,
this, this, the others in reverse; eager ms: 50 back-to-back calls between
CUDA events (the host's issue cost included, as `wrapper_ms`), the others'
through their bare C interface, this version's through its wrapper. Cases: the paged engine's shape (8
slots, 4 kv heads of 512, pages of 16, 16 a slot, a pool of 129, positions
130-207, bf16 and f32), 2 kv heads, 32 query heads of 128 on one kv head,
head_dim 1024, and long context (256 pages a slot, a pool of 2049,
positions 3990-4010). One JSON line a case; exits 1 without a card. Imports
torch and the port only.

    python3 scripts/paged_decode_probe.py [--against OTHER_CHECKOUT/<package>/csrc ...]
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
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# (name, heads, kv heads, head_dim, pages a slot, pool pages, positions, dtype)
CASES = (("engine", 4, 4, 512, 16, 129, (130, 207), torch.bfloat16),
         ("long", 4, 4, 512, 256, 2049, (3990, 4010), torch.bfloat16),
         ("gqa", 4, 2, 512, 16, 129, (130, 207), torch.bfloat16),
         ("g32", 32, 1, 128, 16, 129, (130, 207), torch.bfloat16),
         ("d1024", 2, 2, 1024, 16, 129, (130, 207), torch.bfloat16),
         ("engine_f32", 4, 4, 512, 16, 129, (130, 207), torch.float32))
SLOTS, BLOCK_LEN = 8, 16


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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, calls: int = 50) -> float:
    """Milliseconds a call over back-to-back eager calls between CUDA
    events: the host's issue rate where that is slower than the device."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def launches_ms(fn, calls: int = 20) -> dict:
    """Device ms a call of each kernel fn launches, by name (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"paged_decode_\w+?_kernel(<[^>]*>)?", e.name)
            name = m.group(0) if m else e.name[:60]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


class Other:
    """Another build of csrc/paged_decode.cu behind its own C interface."""

    def __init__(self, lib: ctypes.CDLL, label: str):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        self.lib, self.label = lib, label
        self.split = hasattr(lib, "ktwe_paged_decode_split")
        if self.split:
            for fn, argtypes in kernels.SIGNATURES["paged_decode"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        else:
            lib.ktwe_paged_decode_fwd.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])
            lib.ktwe_paged_decode_fwd.restype = ctypes.c_int
        lib.ktwe_error_string.argtypes = [ctypes.c_int]
        lib.ktwe_error_string.restype = ctypes.c_char_p

    def __call__(self, q, kp, vp, table, pos):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        b, h, d = q.shape
        nb, bl, kh, _ = kp.shape
        mb = table.shape[1]
        dt = kernels.DTYPE_CODES[q.dtype]
        stream = kernels.stream_handle(q)
        out = torch.empty_like(q)
        if not self.split:
            code = self.lib.ktwe_paged_decode_fwd(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), b, h, kh, d, nb, bl, mb,
                d ** -0.5, dt, 0, stream)
            kernels.check(self.lib, self.label, code)
            return out
        split_len = self.lib.ktwe_paged_decode_split_len(b, h, kh, d,
                                                         mb * bl, dt)
        splits = -(-(mb * bl) // split_len)
        acc = torch.empty((splits, b, h, d), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((splits, b, h, 2), dtype=torch.float32,
                         device=q.device)
        code = self.lib.ktwe_paged_decode_split(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            pos.data_ptr(), acc.data_ptr(), ml.data_ptr(), b, h, kh, d, nb,
            bl, mb, split_len, d ** -0.5, dt, 0, stream)
        kernels.check(self.lib, self.label, code)
        code = self.lib.ktwe_paged_decode_combine(
            acc.data_ptr(), ml.data_ptr(), out.data_ptr(), b * h, d, splits,
            dt, 0, stream)
        kernels.check(self.lib, self.label, code)
        return out


def build_other(csrc: Path) -> Other:
    """Build csrc/paged_decode.cu of another version with the port's flags."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    label = csrc.resolve().parents[1].name
    h = hashlib.sha256()
    for part in (csrc / "paged_decode.cu", csrc / "common.cuh"):
        h.update(part.read_bytes())
    out = kernels.BUILD_DIR.parent / "probe" / (
        f"paged_decode-{label}-{h.hexdigest()[:16]}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                              str(out), str(csrc / "paged_decode.cu")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc}:\n{res.stdout}"
                               f"{res.stderr}")
    return Other(ctypes.CDLL(str(out)), label)


def inputs(dev, gen, cpu_gen, h, kh, d, mb, nb, lo_hi, dtype):
    table = (torch.randperm(nb - 1, generator=cpu_gen)[:SLOTS * mb]
             + 1).reshape(SLOTS, mb).to(torch.int32).to(dev)
    pos = torch.linspace(*lo_hi, SLOTS).round().to(torch.int32).to(dev)
    q = torch.randn((SLOTS, h, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn((nb, BLOCK_LEN, kh, d), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((nb, BLOCK_LEN, kh, d), generator=gen,
                     device=dev).to(dtype)
    return q, kp, vp, table, pos


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], type=Path,
                    help="csrc directory of another version (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_decode_probe: no CUDA device", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.ops import paged_attention as paged
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    others = [build_other(p) for p in args.against]
    gen = torch.Generator(device=dev).manual_seed(1)
    cpu_gen = torch.Generator().manual_seed(3)
    for name, h, kh, d, mb, nb, lo_hi, dtype in CASES:
        q, kp, vp, table, pos = inputs(dev, gen, cpu_gen, h, kh, d, mb, nb,
                                       lo_hi, dtype)
        want = paged.paged_decode_attention_plain(q, kp, vp, table, pos,
                                                  block_len=BLOCK_LEN).float()

        def this():
            return paged.paged_decode_attention(q, kp, vp, table, pos,
                                                block_len=BLOCK_LEN)
        versions, refused = [], []
        for o in others:
            try:
                o(q, kp, vp, table, pos)
                versions.append((o.label, lambda o=o: o(q, kp, vp, table,
                                                         pos)))
            except RuntimeError:          # a shape that version refuses
                refused.append(o.label)
        errs = {label: float((fn().float() - want).abs().max())
                for label, fn in versions + [("this", this)]}
        times = {label: [] for label in errs}
        for label, fn in versions:
            times[label].append(device_ms(fn))
        eager = {label: eager_ms(fn) for label, fn in versions}
        for _ in range(2):
            times["this"].append(device_ms(this))
        eager["this"] = eager_ms(this)
        for label, fn in reversed(versions):
            times[label].append(device_ms(fn))
        es = q.element_size()
        n_pos = sum(int(p) + 1 for p in pos.tolist())
        bts = (2 * n_pos * kh * d * es + 2 * q.numel() * es
               + 4 * table.numel() + 4 * pos.numel())
        j = torch.arange(mb * BLOCK_LEN, device=dev)
        rows = table.long()[:, j // BLOCK_LEN] * BLOCK_LEN + j % BLOCK_LEN
        kd, vd = (pg.reshape(nb * BLOCK_LEN, kh, d)[rows].transpose(1, 2)
                  .repeat_interleave(h // kh, dim=1).contiguous()
                  for pg in (kp, vp))
        mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask))
        split_len, splits = paged.split_plan(SLOTS, h, kh, d, mb * BLOCK_LEN,
                                             dtype)
        print(json.dumps(dict(
            case=name, dtype=str(dtype).split(".")[-1],
            shape=dict(b=SLOTS, h=h, kh=kh, d=d, bl=BLOCK_LEN, mb=mb, nb=nb),
            pos=[int(p) for p in pos.tolist()], split_len=split_len,
            splits=splits, refused_by=refused, max_abs_err=errs,
            ok={k: v <= TOL[dtype] for k, v in errs.items()},
            device_ms=times, eager_ms=eager,
            bound_ms=bts / HBM_BYTES_PER_S * 1e3,
            dense_sdpa_ms=sdpa, this_kernels_ms=launches_ms(this))),
            flush=True)
        del kd, vd, kp, vp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
