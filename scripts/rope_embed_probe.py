"""Probe of the RoPE kernels and the embedding gather on one NVIDIA card: how
far each output is from its plain version, the device time of each kernel
beside its bytes bound, the launch floor and, for the gather, `F.embedding`
on the same ids. With `--against DIR` (repeatable), the same for other
versions of `csrc/rope.cu` and `csrc/embed.cu` in the same process, each
built from a DIR holding that version's sources and `common.cuh`
(labelled by the directory two levels above it) and called through its own
C interface: this one's, whose RoPE launchers take strided tables and a
sign flag, or the first one's, which takes contiguous tables only.

Device ms: 50 calls captured in one CUDA graph, replayed 5 times between
CUDA events (chip_smoke.py's `device_ms`; 10 calls, 3 replays at the
training shapes), taken in turns: the others, this, this, the others in
reverse. The launch floor is a one-element `zero_()` taken alike. Cases,
bf16 unless named:
  - rope (row 3): a serving prefill chunk (1, 128, 4, 512) at offsets 0 and
    128 of the (256, 256, 2) table, and the training VJP (8, 2048, 16, 128)
    (the rotation by -sin) in bf16 and f32. This version reads the table's
    cos/sin views in place (`in_place`) and contiguous copies
    (`contiguous`); a version of contiguous tables only gets the copies.
    `path_ms` times the call as `attention.apply_rope` and its VJP make it:
    for such a version the two column copies and the kernel forward, the
    -sin and the kernel backward; for this one the kernel on the views;
  - rope_t and rope_t_inv (rows 4, 5): the flagship microbatch (8, 2048,
    4, 512), in place and contiguous alike;
  - embed_gather (row 13): a decode step (8 ids), a prefill chunk (1 x
    128), the flagship microbatch's `tokens[:, :-1]` view of 8 x 2049 ids
    on the bf16 table (32768 x 2048), the same ids on the f32 master table
    (rows rounded to bf16).
One JSON line a case; exits 1 without a card. Imports torch and the port
only.

    python3 scripts/rope_embed_probe.py [--against OTHER_CHECKOUT/<package>/csrc ...]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12
bf16, f32 = torch.bfloat16, torch.float32
V, D = 32768, 2048


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


class Version:
    """One build of rope.cu and embed.cu behind its own C interface."""

    def __init__(self, rope_lib, embed_lib, strided: bool, label: str):
        self.rope, self.embed = rope_lib, embed_lib
        self.strided, self.label = strided, label

    def rope_fwd(self, x, cos, sin, inverse=False):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        b, s, h, d = x.shape
        out = torch.empty_like(x)
        if self.strided:
            code = self.rope.ktwe_rope_fwd(
                x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                b, s, h, d // 2, *cos.stride(), *sin.stride(), int(inverse),
                kernels.DTYPE_CODES[x.dtype], 0, kernels.stream_handle(x))
        else:          # no sign flag: the caller passes -sin itself
            assert not inverse
            code = self.rope.ktwe_rope_fwd(
                x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                b, s, h, d // 2, kernels.DTYPE_CODES[x.dtype], 0,
                kernels.stream_handle(x))
        kernels.check(self.rope, f"{self.label} rope", code)
        return out

    def rope_t(self, x, cos, sin, heads, to_flat):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        if to_flat:
            b, s, h, d = x.shape
            out = torch.empty((b * h, s, d), dtype=x.dtype, device=x.device)
        else:
            bh, s, d = x.shape
            b, h = bh // heads, heads
            out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
        strides = (*cos.stride(), *sin.stride()) if self.strided else ()
        code = self.rope.ktwe_rope_t(
            x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, s,
            h, d // 2, *strides, int(to_flat), kernels.DTYPE_CODES[x.dtype], 0,
            kernels.stream_handle(x))
        kernels.check(self.rope, f"{self.label} rope_t", code)
        return out

    def gather(self, table, ids, scale, out_dtype, round_rows):
        from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
        out = torch.empty((*ids.shape, table.shape[1]), dtype=out_dtype,
                          device=table.device)
        if ids.dim() == 2:
            cols, (s0, s1) = ids.shape[1], ids.stride()
        else:
            cols, s0, s1 = ids.shape[0], 0, ids.stride(0)
        code = self.embed.ktwe_embed_gather(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(),
            cols, s0, s1, table.shape[0], table.shape[1], float(scale),
            ids.element_size(), int(round_rows),
            kernels.DTYPE_CODES[table.dtype], kernels.DTYPE_CODES[out_dtype],
            0, kernels.stream_handle(table))
        kernels.check(self.embed, f"{self.label} embed", code)
        return out


def bind(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ktwe_error_string.argtypes = [ctypes.c_int]
    lib.ktwe_error_string.restype = ctypes.c_char_p
    return lib


def build_other(csrc: Path) -> Version:
    """Build another version's rope.cu and embed.cu with the port's flags
    and bind each through its own C interface."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    label = csrc.resolve().parents[1].name
    strided = "long long cos_row" in (csrc / "rope.cu").read_text()
    _P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    rope_sigs = kernels.SIGNATURES["rope"] if strided else {
        "ktwe_rope_fwd": [_P] * 4 + [_LL] + [_I] * 5 + [_P],
        "ktwe_rope_t": [_P] * 4 + [_LL] + [_I] * 6 + [_P]}
    libs, procs = {}, {}
    for name in ("rope", "embed"):
        h = hashlib.sha256()
        for part in (csrc / f"{name}.cu", csrc / "common.cuh"):
            h.update(part.read_bytes())
        out = kernels.BUILD_DIR.parent / "probe" / (
            f"{name}-{label}-{h.hexdigest()[:16]}.so")
        out.parent.mkdir(parents=True, exist_ok=True)
        libs[name] = out
        if not out.exists():
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                 str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc}/{name}.cu:\n{log}")
        print(f"== {label} {name}\n{log}", flush=True)
    return Version(bind(libs["rope"], rope_sigs),
                   bind(libs["embed"], kernels.SIGNATURES["embed"]), strided,
                   label)


def in_turns(versions, fn, **it) -> dict:
    """Device ms of fn(version) for each version: the others, this, this,
    the others in reverse."""
    others, this = versions[:-1], versions[-1]
    order = others + [this, this] + others[::-1]
    times = {v.label: [] for v in versions}
    for v in order:
        times[v.label].append(device_ms(lambda: fn(v), **it))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], type=Path,
                    help="csrc directory of another version (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rope_embed_probe: no CUDA device", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.ops import (attention, embed,
                                                         kernels, rope)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"build_s": kernels.build(["rope", "embed"])}),
          flush=True)
    for name in ("rope", "embed"):
        print(f"== this {name}\n{kernels.build_log(name)}", flush=True)
    versions = [build_other(p) for p in args.against]
    versions.append(Version(kernels.library("rope"), kernels.library("embed"),
                            True, "this"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.empty(1, device=dev)
    floor = [device_ms(lambda: z.zero_()) for _ in range(2)]
    print(json.dumps({"launch_floor_ms": floor}), flush=True)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # Row 3: the rotation and its VJP.
    for case, (b, s, h, d), off, dt, inverse in (
            ("serve_chunk", (1, 128, 4, 512), 0, bf16, False),
            ("serve_chunk_at_128", (1, 128, 4, 512), 128, bf16, False),
            ("train_vjp", (8, 2048, 16, 128), 0, bf16, True),
            ("train_vjp_f32", (8, 2048, 16, 128), 0, f32, True)):
        freqs = attention.rope_frequencies(d, 256 if s < 256 else s,
                                           device=dev)
        fr = freqs[off:off + s]
        views = (fr[..., 0], fr[..., 1])
        copies = (views[0].contiguous(), views[1].contiguous())
        x = randn(b, s, h, d, dtype=dt)
        sin_arg = -copies[1] if inverse else copies[1]
        want = rope.rope_rotate_plain(x, copies[0], sin_arg)

        def kernel(v, tabs):   # the kernel alone on the given tables
            if v.strided:
                return v.rope_fwd(x, *tabs, inverse=inverse)
            return v.rope_fwd(x, copies[0], sin_arg)
        it = dict(iters=10, replays=3) if x.numel() > 1 << 22 else {}
        row = dict(kernel="rope", case=case, shape=[b, s, h, d], offset=off,
                   dtype=str(dt).split(".")[-1], inverse=inverse,
                   bound_ms=(2 * x.numel() * x.element_size()
                             + 8 * copies[0].numel()) / HBM_BYTES_PER_S * 1e3)
        row["bit_for_bit"] = {
            f"{v.label}/{kind}": bool(torch.equal(kernel(v, tabs), want))
            for v in versions
            for kind, tabs in (("in_place", views), ("contiguous", copies))
            if v.strided or kind == "contiguous"}
        row["contiguous_ms"] = in_turns(versions,
                                        lambda v: kernel(v, copies), **it)
        row["in_place_ms"] = device_ms(lambda: kernel(versions[-1], views),
                                       **it)

        def path(v):   # the call as apply_rope / its VJP make it
            if v.strided:
                return v.rope_fwd(x, *views, inverse=inverse)
            if inverse:
                return v.rope_fwd(x, copies[0], -copies[1])
            return v.rope_fwd(x, views[0].contiguous(),
                              views[1].contiguous())
        row["path_ms"] = in_turns(versions, path, **it)
        row["plain_ms"] = device_ms(
            lambda: rope.rope_rotate_plain(x, copies[0], sin_arg), **it)
        print(json.dumps(row), flush=True)
        del x, want
        torch.cuda.empty_cache()

    # Rows 4, 5: the t-layout pair at the flagship microbatch.
    b, s, h, d = 8, 2048, 4, 512
    freqs = attention.rope_frequencies(d, s, device=dev)
    views = (freqs[..., 0], freqs[..., 1])
    copies = (views[0].contiguous(), views[1].contiguous())
    x, g = randn(b, s, h, d), randn(b * h, s, d)
    it = dict(iters=10, replays=3)
    for kernel, inp, to_flat, want in (
            ("rope_t", x, True, rope.rope_rotate_t_plain(x, *copies)),
            ("rope_t_inv", g, False,
             rope.rope_rotate_t_inv_plain(g, *copies, h))):
        row = dict(kernel=kernel, case="flagship", shape=[b, s, h, d],
                   dtype="bfloat16",
                   bound_ms=(2 * x.numel() * 2 + 8 * copies[0].numel())
                   / HBM_BYTES_PER_S * 1e3)
        row["bit_for_bit"] = {
            f"{v.label}/{kind}": bool(torch.equal(
                v.rope_t(inp, *tabs, h, to_flat), want))
            for v in versions
            for kind, tabs in (("in_place", views), ("contiguous", copies))
            if v.strided or kind == "contiguous"}
        row["contiguous_ms"] = in_turns(
            versions, lambda v: v.rope_t(inp, *copies, h, to_flat), **it)
        row["in_place_ms"] = device_ms(
            lambda: versions[-1].rope_t(inp, *views, h, to_flat), **it)
        print(json.dumps(row), flush=True)
    del x, g
    torch.cuda.empty_cache()

    # Row 13: the gather.
    master = 0.02 * torch.randn((V, D), generator=gen, device=dev)
    table_bf = master.to(bf16)

    def ids(*shape):
        return torch.randint(0, V, shape, generator=gen, device=dev)
    for case, table, i in (("decode", table_bf, ids(8)),
                           ("prefill", table_bf, ids(1, 128)),
                           ("flagship", table_bf, ids(8, 2049)[:, :-1]),
                           ("train_f32_master", master,
                            ids(8, 2049)[:, :-1])):
        scale = embed.embed_scale(D, bf16)
        want = embed.embed_gather_plain(table, i, scale, bf16, True)
        n = i.numel()
        it = dict(iters=10, replays=3) if n * D > 1 << 22 else {}
        row = dict(kernel="embed_gather", case=case, ids=list(i.shape),
                   table_dtype=str(table.dtype).split(".")[-1],
                   bound_ms=(n * D * (table.element_size() + 2)
                             + n * i.element_size()) / HBM_BYTES_PER_S * 1e3)
        row["bit_for_bit"] = {
            v.label: bool(torch.equal(v.gather(table, i, scale, bf16, True),
                                      want)) for v in versions}
        row["ms"] = in_turns(
            versions, lambda v: v.gather(table, i, scale, bf16, True), **it)
        row["library_ms"] = device_ms(
            lambda: torch.nn.functional.embedding(i, table), **it)
        row["plain_ms"] = device_ms(
            lambda: embed.embed_gather_plain(table, i, scale, bf16, True),
            **it)
        print(json.dumps(row), flush=True)
    floor.append(device_ms(lambda: z.zero_()))
    print(json.dumps({"launch_floor_ms": floor}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
