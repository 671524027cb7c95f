"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the port's serving path at the default serve dims (vocab 32768,
d_model 2048, 3 layers, 4 heads of 512, d_ff 16384, max_seq 256, 8 slots,
prefill_len 128, decode_chunk 8), its training path at the trainer's
defaults (vocab 32768, d_model 2048, 8 layers, 16 heads of 128, d_ff 8192,
seq 2048, batch 8) and at the flagship training configuration
(train/flagship.py: 3 layers, 4 heads of 512, d_ff 16384, seq 2048,
single-chunk fused LM-head CE, microbatches of 8), from seeded random
inits in bf16:

  1. prints the card's name and power limit (nvidia-smi) and builds every
     kernel from csrc/, one nvcc per source, all at once;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the serving, training and flagship paths give it (and small
     ragged shapes, bf16 and f32), and times on the device (calls captured in one
     CUDA graph, replayed) the kernel, the plain version and, where one
     PyTorch call computes the same function, that call (for the RMSNorm
     backward the op F.rms_norm's backward runs,
     aten._fused_rms_norm_backward, timed as the kernels are, and also
     torch.autograd.grad of F.rms_norm, eager; for the attention backward
     torch.autograd.grad of scaled_dot_product_attention on a retained
     graph, eager, between CUDA events; for the fused CE, the head matmul
     plus F.cross_entropy, two calls, and their backward to the hidden);
     at the trainer's rows also what the card's memory gives for the
     RMSNorm's bytes through one call (`copy_`, `torch.add`); the
     wrapper's eager per-call rate, which includes the host's cost of
     issuing it, is reported apart. The paged decode kernel is also timed
     beside `scaled_dot_product_attention` over the same rows laid out as a
     contiguous cache (`dense_sdpa_ms`, a yardstick: that call does no
     table walk, so it is not the same function). The embedding gather is
     timed beside `F.embedding` (the gather alone) and the eager
     `table.to(dtype)[ids] * scale` it replaced (`eager_ms`), the relayouts
     beside `x.transpose(1, 2).contiguous()`;
  3. runs the main paths, each with the launch counters set to 0 just
     before it and read just after: the dense engine on 8 requests of
     128-token prompts plus one of 160 (chunked prefill at offset 128); the
     serve main in-process answering three POST /v1/generate (one
     streamed); the paged engine (kv_block_len 16) on 8 requests of 160
     tokens sharing a 128-token prefix plus one cold request of 160, after
     a warm-up that published the prefix, so 8 of the 9 start from pool
     pages; the paged serve main answering two requests that share a
     128-token prefix; the trainer main in-process, 4 steps at batch 8
     (the p/ds stash is over its gate, so dK/dV are recomputed) and 2 at
     batch 4 (the stash path); and the flagship configuration through
     train.trainer.train_loop, cut to batch 32 (grad_accum 4 instead of
     32) for 1 warm-up and 3 timed steps (the t-layout RoPE pair, flash at
     head_dim 512 with the p/ds stash, the fused CE kernels). Every phase
     must launch exactly the kernels its prefill chunks, decode steps,
     train steps and microbatches need (one embedding gather a chunk, step
     and microbatch; the flagship's relayout pair 2L times each a
     microbatch; on the paged
     path the paged decode kernel L times a step, and never the dense
     decode attention). The dense phase's first prefill chunk and first
     tokens are checked against the plain versions; the paged engine is
     held to the dense engine: identical greedy transcripts in f32 on the
     same weights (a hard gate), and the count of identical ones in bf16,
     printed. Two f32 training gates at full width (the trainer's: 2
     layers, batch 2, seq 512; the flagship's: 1 layer, batch 1, seq 512)
     hold the loss and every gradient leaf through the kernels, once with
     the p/ds stash and once with dK/dV recomputed, to the same step
     through the plain versions; the trainers' losses and grad norms must
     be finite. The backward kernels are held to limits scaled to each
     output's own values (BWD_RTOL, BWD_ATOL_OF_RMS);
     Every bf16 flash forward of every phase must run the tensor-core
     (wgmma) body, and so must every bf16 dQ and stash dK/dV launch (the
     train phases and the flagship at head_dim 512), every recompute
     dK/dV of the train phase (head_dim 128) and every fused CE forward
     and backward of the flagship; no f32 gate's flash or fused CE kernel
     may. The flash, RMSNorm and fused CE libraries' build seconds,
     registers, spills and shared memory are printed first, and each backward and
     fused CE case names the body (and its instance) that ran it;
  4. opens a torch.profiler window on one step of the trainer main at its
     defaults and one flagship step of a single microbatch, after the
     timed phases, and prints the ten device operations with the most
     self time and the device's idle share in each;
  5. prints the {"kernels": [...]} line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failed phase exits non-zero before the result line. Without a CUDA card
it exits 1 at once.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense) for the bound column:
# HBM, the bf16 tensor-core rate and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=3, n_heads=4,
                  n_kv_heads=4, d_ff=16384, max_seq=256)
NUM_SLOTS, PREFILL_LEN, DECODE_CHUNK = 8, 128, 8
N_REQUESTS, PROMPT_LEN, LONG_PROMPT_LEN, NEW_TOKENS = 8, 128, 160, 48
# The paged phase: pages of 16 tokens (16 per slot, an auto pool of 129),
# 8 requests sharing a 128-token prefix with 32-token suffixes, one cold.
KV_BLOCK_LEN, SHARED_PREFIX, SUFFIX = 16, 128, 32

# Training: the trainer main's defaults (cmd/trainer.py of the JAX package),
# and the stash-path batch (the p/ds stash is 1.07 GB at batch 4, under the
# 1.2 GB gate; 2.15 GB at batch 8, over it).
TRAIN_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
                  d_ff=8192, seq_len=2048)
TRAIN_BATCH, STASH_BATCH, TRAIN_STEPS, STASH_STEPS = 8, 4, 4, 2
# The f32 gate: full width, 2 layers, batch 2, seq 512.
GATE_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=2, n_heads=16,
                 n_kv_heads=16, d_ff=8192, max_seq=512)
GATE_BATCH, GATE_LOSS_RTOL, GATE_LEAF_RTOL = 2, 1e-5, 1e-3
# The flagship training configuration (train/flagship.py: 3 layers, 4 heads
# of 512, d_ff 16384, seq 2048, bf16, single-chunk fused CE) at its
# microbatch of 8, cut from 32 microbatches a step to 4 (batch 32) to keep
# the run inside its time limit; 1 warm-up step and 3 timed ones.
FLAGSHIP_BATCH, FLAGSHIP_ACCUM, FLAGSHIP_STEPS = 32, 4, 4
FLAGSHIP_MICRO = FLAGSHIP_BATCH // FLAGSHIP_ACCUM
# Its f32 gate: the flagship widths, 1 layer, batch 1, seq 512.
FLAGSHIP_GATE_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=1,
                          n_heads=4, n_kv_heads=4, d_ff=16384, max_seq=512,
                          ce_chunk=32768, ce_cache_logits=True)
FLAGSHIP_GATE_BATCH = 1
# Fused CE forward vs plain: lse and gold relative (bf16: the tensor cores
# sum the logits in another order; f32: the f32 pipes in contraction order
# against cuBLAS); stash and dlg within one bf16 ulp (an f32 value within
# the sums' difference of a bf16 midpoint rounds to its neighbour), with
# the backward limits' floor of BWD_ATOL_OF_RMS[bf16] times the output's
# root mean square for entries near zero, where the sums' difference
# (~1e-5 at D 2048) is more than the value's ulp.
CE_STAT_RTOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}

# Kernel vs plain version in bf16: both round once from f32, so they differ
# by at most a couple of bf16 ulps (2^-8 relative) where their f32 sums are
# taken in another order.
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# First prefill chunk's f32 logits, kernels vs plain versions: bf16
# activations through 3 layers; a one-ulp flip upstream moves a logit by
# about 1e-2 at these magnitudes.
LOGITS_ATOL = 0.1
# Backward kernels vs plain versions: each output (and the p/ds stash) is
# held to a limit scaled to its own values. rtol: in bf16 one rounding (an
# ulp is at most 2^-7 of the value) of f32 results that differ only in
# summation order; in f32 those sums themselves (a few thousand terms: a
# few 1e-6 of the output's size). atol, for entries near zero where
# cancellation decides the last bits, is this fraction of the output's
# root mean square.
BWD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
BWD_ATOL_OF_RMS = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


# Each flash and fused CE kernel's count of launches on its bf16
# tensor-core body.
WGMMA_COUNTERS = {"flash_attention": "flash_attention_wgmma",
                  "flash_attention_bwd_dq": "flash_attention_bwd_dq_wgmma",
                  "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_wgmma",
                  "flash_attention_bwd_dkv_stash":
                      "flash_attention_bwd_dkv_stash_wgmma",
                  "fused_ce_fwd": "fused_ce_fwd_wgmma",
                  "fused_ce_bwd": "fused_ce_bwd_wgmma"}
# The backward's tensor-core bodies in a build log, by kernel name.
BWD_WGMMA_INSTANCES = {
    "flash_bwd_dq_wgmma_kernel":
        "bf16, d<=128, 128 resident query rows, 64-key tiles, 2 stages",
    "flash_bwd_dkv_wgmma_kernel":
        "bf16, d<=128, 128 resident keys, 64-query tiles, 2 stages",
    "flash_bwd_dq_wide_wgmma_kernel":
        "bf16, 128<d<=512, 64 resident query rows, 32-key tiles, one stage "
        "each of K and V",
    "flash_bwd_dkv_stash_wgmma_kernelILb1E":
        "bf16, d<=512, 128 keys x 128-column slice, 64-query tiles, 3 "
        "stages, P and dS by TMA",
    "flash_bwd_dkv_stash_wgmma_kernelILb0E":
        "bf16, d<=512, 128 keys x 128-column slice, 64-query tiles, 3 "
        "stages, P and dS copied by the producer (Sk % 8 != 0)"}
# The fused CE library's kernels in a build log, by the name's distinct part.
CE_KERNELS = {
    "ce_wgmma_kernelILb1E": "ce_wgmma_kernel<forward: bf16, 128 x 256 "
                            "tiles, 64 deep, 4 stages, persistent>",
    "ce_wgmma_kernelILb0E": "ce_wgmma_kernel<backward dH: bf16, 128 x 256 "
                            "tiles, 64 deep, 4 stages, persistent>",
    "ce_dlg_kernel": "ce_dlg_kernel<backward dlg: bf16>",
    "ce_combine_kernel": "ce_combine_kernel<forward statistics>",
    "simt13ce_fwd_kernel": "ce_fwd_kernel<float>",
    "simt13ce_bwd_kernel": "ce_bwd_kernel<float>"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _events_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Device milliseconds per call: `iters` calls captured in one CUDA
    graph and replayed `replays` times between CUDA events, so the host's
    cost of issuing each call (Python, ctypes, launch) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up off the graph
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _events_ms(run) / (iters * replays)
    del graph
    return ms


def wrapper_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call over `iters` eager back-to-back calls: the
    rate at which the host issues them wherever that is slower than the
    device (small kernels), else the device time."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run) / iters


def bound(bytes_moved: float, flops: float, dtype=torch.bfloat16):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expected_launches(n_layers: int, lifetime: dict,
                      paged: bool = False) -> dict:
    """Kernel launches an engine run must have made: every prefill chunk
    runs one embedding gather, 2L+1 norms, 2L RoPE rotations (q and k) and
    L flash calls, all on the tensor-core body (serving is bf16); every
    decode step one gather, 2L+1 norms and, on the paged engine, L paged
    decode calls (dense decode RoPE and attention are plain torch)."""
    chunks, steps = lifetime["prefill_chunks"], lifetime["decode_steps"]
    want = {"embed_gather": chunks + steps,
            "rms_norm": (2 * n_layers + 1) * (chunks + steps),
            "rope": 2 * n_layers * chunks,
            "flash_attention": n_layers * chunks,
            "flash_attention_wgmma": n_layers * chunks}
    if paged:
        want["paged_decode"] = n_layers * steps
    return want


def cast_params(params, dtype):
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def errors(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float):
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail("kernel output has non-finite values")
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all())
    rel = float((diff / w.abs().clamp_min(1e-6)).max())
    return float(diff.max()), rel, ok


def bwd_errors(got: torch.Tensor, want: torch.Tensor):
    """`errors` at the backward limits for want's dtype (BWD_RTOL, and
    BWD_ATOL_OF_RMS times want's root mean square)."""
    rms_w = float(torch.linalg.vector_norm(want, dtype=torch.float32)) \
        / max(1, want.numel()) ** 0.5
    return errors(got, want, BWD_ATOL_OF_RMS[want.dtype] * rms_w,
                  BWD_RTOL[want.dtype])


def ptxas_entries(log: str) -> list:
    """Each kernel of a library's build log (`nvcc -Xptxas -v`): its name,
    registers at launch, spill bytes and static shared memory."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            shape = re.search(r"ShapeILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
            bwd = re.search(r"(flash_bwd_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                            name)
            wgmma = next((k for k in BWD_WGMMA_INSTANCES if k in name), None)
            ce = next((k for k in CE_KERNELS if k in name), None)
            rms = re.search(r"(rms_norm_\w+?_kernel)I(f|13__nv_bfloat16)"
                            r"(f|13__nv_bfloat16|S1_)Li(\d+)ELi(\d+)E", name)
            fin = re.search(r"rms_dw_finalize_kernelI(f|13__nv_bfloat16)"
                            r"Li(\d+)E", name)
            if rms:
                x_t = "f32" if rms.group(2) == "f" else "bf16"
                w_t = {"f": "f32", "S1_": x_t}.get(rms.group(3), "bf16")
                name = "%s<x %s, w %s, %s a vector, V %s>" % (
                    rms.group(1), x_t, w_t, rms.group(4), rms.group(5))
            elif fin:
                name = "rms_dw_finalize_kernel<dw %s, %s a load>" % (
                    "f32" if fin.group(1) == "f" else "bf16", fin.group(2))
            elif ce:
                name = CE_KERNELS[ce]
            elif shape:
                name = ("flash_fwd_wgmma_kernel<d<=%s, %s query rows, %s keys,"
                        " %s stage(s)>" % shape.groups())
            elif "flash_fwd_kernelIf" in name:
                name = "flash_fwd_kernel<float>"
            elif bwd:
                name = "%s<%s, d<=%s>" % (
                    bwd.group(1), "float" if bwd.group(2) == "f" else "bf16",
                    bwd.group(3))
            elif wgmma:
                name = "%s<%s>" % (wgmma.split("I")[0],
                                   BWD_WGMMA_INSTANCES[wgmma])
            cur = dict(kernel=name)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def flash_body(flash, dtype, d: int) -> dict:
    """Which forward body `ktwe_flash_attention_fwd` runs for dtype and
    head_dim, and the dynamic shared memory a block of it takes."""
    lib = flash.kernels.library("flash_attention")
    smem = lib.ktwe_flash_attention_smem(d, flash.kernels.DTYPE_CODES[dtype])
    if dtype != torch.bfloat16:
        return dict(body="f32 pipes", dynamic_smem_bytes=smem)
    return dict(body="wgmma", instance="d<=128" if d <= 128 else "d<=512",
                dynamic_smem_bytes=smem)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dev, rms, rope, flash, paged, attn_mod) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    d, h, hd = SERVE_DIMS["d_model"], SERVE_DIMS["n_heads"], 2048 // 4
    out = {}

    # RMSNorm: a prefill chunk's rows, a decode step's, and a ragged small
    # shape.
    cases = []
    w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(torch.bfloat16)
    for case, rows, width in (("prefill", PREFILL_LEN, d),
                              ("decode", NUM_SLOTS, d), ("ragged", 5, 203)):
        x = randn(rows, width)
        ww = w if width == d else (1.0 + 0.1 * randn(width)).to(torch.bfloat16)
        got = rms.rms_norm(x, ww)
        want = rms.rms_norm_plain(x, ww)
        ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
        bts = 2 * x.numel() * 2 + ww.numel() * 2
        b_ms, b_by = bound(bts, 4.0 * x.numel())
        lib_ms = device_ms(lambda: torch.nn.functional.rms_norm(
            x, (width,), ww, 1e-6))
        cases.append(dict(case=case, shape=[rows, width], dtype="bfloat16",
                          max_abs_err=ea, max_rel_err=er, ok=ok,
                          ms=device_ms(lambda: rms.rms_norm(x, ww)),
                          wrapper_ms=wrapper_ms(lambda: rms.rms_norm(x, ww)),
                          plain_ms=device_ms(
                              lambda: rms.rms_norm_plain(x, ww)),
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    out["rms_norm"] = cases

    # RoPE: one prefill chunk's q (offset 0 and 128), and a ragged shape.
    cases = []
    freqs = attn_mod.rope_frequencies(hd, SERVE_DIMS["max_seq"], 10000.0, dev)
    for shape, offset in (((1, PREFILL_LEN, h, hd), 0),
                          ((1, PREFILL_LEN, h, hd), PREFILL_LEN),
                          ((2, 7, 3, 24), 5)):
        x = randn(*shape)
        s, dd = shape[1], shape[3]
        fr = (freqs if dd == hd else attn_mod.rope_frequencies(
            dd, 64, 10000.0, dev))[offset:offset + s]
        c, sn = fr[..., 0].contiguous(), fr[..., 1].contiguous()
        got = rope.rope_rotate(x, c, sn)
        want = rope.rope_rotate_plain(x, c, sn)
        ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
        bts = 2 * x.numel() * 2 + 2 * c.numel() * 4
        b_ms, b_by = bound(bts, 3.0 * x.numel())
        cases.append(dict(shape=list(shape), offset=offset, dtype="bfloat16",
                          max_abs_err=ea, max_rel_err=er, ok=ok,
                          ms=device_ms(lambda: rope.rope_rotate(x, c, sn)),
                          wrapper_ms=wrapper_ms(
                              lambda: rope.rope_rotate(x, c, sn)),
                          plain_ms=device_ms(
                              lambda: rope.rope_rotate_plain(x, c, sn)),
                          bound_ms=b_ms, bound_by=b_by, library_ms=None))
    out["rope"] = cases

    # Flash: a prefill chunk against the static 256-row cache, at q_offset 0
    # and 128, and a ragged GQA shape.
    cases = []
    s_max = SERVE_DIMS["max_seq"]
    for (b, sq, sk, hh, kh, dd), q_off in (((1, PREFILL_LEN, s_max, h, h, hd),
                                            0),
                                           ((1, PREFILL_LEN, s_max, h, h, hd),
                                            PREFILL_LEN),
                                           ((2, 19, 45, 4, 2, 72), 20)):
        q, k, v = randn(b, sq, hh, dd), randn(b, sk, kh, dd), randn(b, sk, kh, dd)
        got = flash.flash_attention(q, k, v, True, q_off, 0)
        want = flash.flash_attention_plain(q, k, v, True, q_off, 0)
        ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
        # Work this run's data needs: query row i sees keys
        # [0, min(sk, q_off + i + 1)).
        vis = [min(sk, q_off + i + 1) for i in range(sq)]
        flops = 4.0 * dd * sum(vis) * b * hh
        kv_rows = max(vis)
        bts = 2 * (2 * q.numel() + 2 * b * kv_rows * kh * dd)
        b_ms, b_by = bound(bts, flops)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kt = kt.repeat_interleave(hh // kh, dim=1)
        vt = vt.repeat_interleave(hh // kh, dim=1)
        mask = (q_off + torch.arange(sq, device=dev)[:, None]
                >= torch.arange(sk, device=dev)[None, :])
        lib_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))

        def kernel():
            return flash.flash_attention(q, k, v, True, q_off, 0)
        cases.append(dict(shape=dict(b=b, sq=sq, sk=sk, h=hh, kh=kh, d=dd),
                          q_offset=q_off, dtype="bfloat16",
                          **flash_body(flash, q.dtype, dd),
                          max_abs_err=ea, max_rel_err=er, ok=ok,
                          ms=device_ms(kernel), wrapper_ms=wrapper_ms(kernel),
                          plain_ms=device_ms(
                              lambda: flash.flash_attention_plain(
                                  q, k, v, True, q_off, 0)),
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    out["flash_attention"] = cases
    out["paged_decode"] = check_paged_decode(dev, gen, paged)
    for name, cs in out.items():
        for c in cs:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


def check_paged_decode(dev, gen, paged) -> list:
    """The paged decode kernel against its plain version in bf16 and f32:
    the paged engine's shape (8 slots, 4 heads of 512, pages of 16, 16 per
    slot, the auto pool of 129, positions 130-207, pages handed out in a
    shuffled order), a GQA shape (2 kv heads), the engine shape with slot 7
    parked (all-trash row at position 255), and a long-context shape for
    timing (256 pages per slot, pool of 2049, positions near 4000)."""
    h, hd, bl = SERVE_DIMS["n_heads"], 2048 // 4, KV_BLOCK_LEN
    shapes = [("engine", 4, 16, 129, (130, 207), False),
              ("gqa", 2, 16, 129, (130, 207), False),
              ("parked", 4, 16, 129, (130, 207), True),
              ("long", 4, 256, 2049, (3990, 4010), False)]
    cpu_gen = torch.Generator().manual_seed(3)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, kh, mb, nb, (lo, hi), parked in shapes:
            b = NUM_SLOTS
            table = (torch.randperm(nb - 1, generator=cpu_gen)[:b * mb]
                     + 1).reshape(b, mb).to(torch.int32)
            pos = torch.linspace(lo, hi, b).round().to(torch.int32)
            if parked:
                table[-1] = 0
                pos[-1] = mb * bl - 1
            table, pos = table.to(dev), pos.to(dev)
            q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
            kp = torch.randn((nb, bl, kh, hd), generator=gen,
                             device=dev).to(dtype)
            vp = torch.randn((nb, bl, kh, hd), generator=gen,
                             device=dev).to(dtype)

            def kernel():
                return paged.paged_decode_attention(q, kp, vp, table, pos,
                                                    block_len=bl)

            def plain():
                return paged.paged_decode_attention_plain(
                    q, kp, vp, table, pos, block_len=bl)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
            # Work this run's data needs: slot b reads its K and V rows of
            # positions [0, pos[b]] for each kv head once.
            n_pos = [int(p) + 1 for p in pos.tolist()]
            es = q.element_size()
            bts = (2 * sum(n_pos) * kh * hd * es + 2 * q.numel() * es
                   + 4 * table.numel() + 4 * pos.numel())
            b_ms, b_by = bound(bts, 4.0 * h * hd * sum(n_pos), dtype)
            # Yardstick: the same rows as a contiguous (B, H, S, D) cache.
            j = torch.arange(mb * bl, device=dev)
            rows = table.long()[:, j // bl] * bl + j % bl
            kd, vd = (pg.reshape(nb * bl, kh, hd)[rows].transpose(1, 2)
                      .repeat_interleave(h // kh, dim=1).contiguous()
                      for pg in (kp, vp))
            mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            sdpa_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, kd, vd, attn_mask=mask))
            cases.append(dict(
                case=name, shape=dict(b=b, h=h, kh=kh, d=hd, bl=bl, mb=mb,
                                      nb=nb),
                pos=pos.tolist(), dtype=str(dtype).split(".")[-1],
                max_abs_err=ea, max_rel_err=er, ok=ok, ms=device_ms(kernel),
                wrapper_ms=wrapper_ms(kernel), plain_ms=device_ms(plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                dense_sdpa_ms=sdpa_ms))
            del kd, vd, kp, vp
    return cases


# ---------------------------------------------------------------------------
# Phase 2b: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def library_bwd_ms(forward, inputs, iters: int = 10) -> float:
    """Milliseconds per backward of one PyTorch call (the yardstick): eager
    torch.autograd.grad on a retained graph, timed with CUDA events."""
    out = forward(*inputs)
    g = torch.randn_like(out)
    return wrapper_ms(lambda: torch.autograd.grad(out, inputs, g,
                                                  retain_graph=True),
                      iters=iters, warmup=2)


def rms_norm_bwd_library_ms(x, w, dy, **it) -> float:
    """Device ms of the one PyTorch call F.rms_norm's backward runs
    (`aten._fused_rms_norm_backward`: dx and dw from x, dy and the saved
    rstd), taken as the kernels are (`device_ms`)."""
    d = x.shape[-1]
    _, rstd = torch.ops.aten._fused_rms_norm(x, [d], w, 1e-6)
    return device_ms(lambda: torch.ops.aten._fused_rms_norm_backward(
        dy, x, [d], rstd, w, [True, True]), **it)


def check_train_kernels(dev, rms, rope, flash, attn_mod, out: dict) -> dict:
    """The backward kernels (and the RoPE VJP) at the trainer's shapes, a
    stash-path shape and small ragged shapes, in bf16 and f32; adds cases
    to `out`."""
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b, s, d = TRAIN_BATCH, TRAIN_DIMS["seq_len"], TRAIN_DIMS["d_model"]
    h = TRAIN_DIMS["n_heads"]
    hd = d // h

    # RMSNorm forward and backward: the trainer's (B*S, D) rows in bf16
    # with f32 weights, then smaller and ragged shapes.
    cases = []
    for rows, width, dt, wdt in ((b * s, d, bf16, f32), (600, d, f32, f32),
                                 (3, 203, bf16, bf16)):
        big = rows * width > 1 << 22
        x, dy = randn(rows, width, dtype=dt), randn(rows, width, dtype=dt)
        w = (1.0 + 0.1 * randn(width, dtype=f32)).to(wdt)
        dx, dw = rms.rms_norm_backward(x, w, dy)
        want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
        ea, er, ok = bwd_errors(dx, want_dx)
        ea_w, er_w, ok_w = bwd_errors(dw, want_dw)
        repeat = bool(torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw))
        es, ws = x.element_size(), w.element_size()
        b_ms, b_by = bound(3 * x.numel() * es + 2 * width * ws,
                           10.0 * x.numel(), dt)
        it = dict(iters=5, replays=4) if big else {}
        cases.append(dict(
            case="train" if big else "small", shape=[rows, width],
            dtype=str(dt).split(".")[-1], w_dtype=str(wdt).split(".")[-1],
            max_abs_err=max(ea, ea_w), max_rel_err=max(er, er_w),
            dw_max_abs_err=ea_w, ok=ok and ok_w and repeat,
            dw_bitwise_repeatable=repeat,
            ms=device_ms(lambda: rms.rms_norm_backward(x, w, dy), **it),
            wrapper_ms=wrapper_ms(lambda: rms.rms_norm_backward(x, w, dy)),
            plain_ms=device_ms(lambda: rms.rms_norm_backward_plain(x, w, dy),
                               **it),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=rms_norm_bwd_library_ms(x, w.to(dt), dy, **it),
            library_eager_ms=library_bwd_ms(
                lambda a, ww: torch.nn.functional.rms_norm(
                    a, (width,), ww, 1e-6),
                (x.detach().requires_grad_(),
                 w.to(dt).detach().requires_grad_()))))
        if big:      # the forward kernel at the trainer's rows too; and
            # what the card's memory gives for each direction's bytes
            # through one PyTorch call: `torch.add` (2 in, 1 out), `copy_`
            o = torch.empty_like(x)
            cases[-1]["add_ms"] = device_ms(
                lambda: torch.add(x, dy, out=o), **it)
            ea, er, okf = errors(rms.rms_norm(x, w), rms.rms_norm_plain(x, w),
                                 BF16_ATOL, BF16_RTOL)
            fb_ms, fb_by = bound(2 * x.numel() * es + width * ws,
                                 4.0 * x.numel(), dt)
            out["rms_norm"].append(dict(
                case="train_fwd", shape=[rows, width], dtype="bfloat16",
                max_abs_err=ea, max_rel_err=er, ok=okf,
                ms=device_ms(lambda: rms.rms_norm(x, w), **it),
                wrapper_ms=wrapper_ms(lambda: rms.rms_norm(x, w)),
                plain_ms=device_ms(lambda: rms.rms_norm_plain(x, w), **it),
                bound_ms=fb_ms, bound_by=fb_by,
                library_ms=device_ms(lambda: torch.nn.functional.rms_norm(
                    x, (width,), w.to(dt), 1e-6), **it),
                copy_ms=device_ms(lambda: o.copy_(x), **it)))
            del o
        del x, dy, dx, want_dx
    out["rms_norm_bwd"] = cases

    # RoPE VJP: the same kernel with -sin, at the trainer's q shape.
    freqs = attn_mod.rope_frequencies(hd, s, 10000.0, dev)
    c, sn = freqs[..., 0].contiguous(), freqs[..., 1].contiguous()
    neg = -sn
    for dt in (bf16, f32):
        x = randn(b, s, h, hd, dtype=dt).requires_grad_()
        g = randn(b, s, h, hd, dtype=dt)
        (got,) = torch.autograd.grad(rope.rope_rotate(x, c, sn), (x,), g)
        want = rope.rope_rotate_plain(g, c, neg)
        ea, er, ok = bwd_errors(got, want)
        b_ms, b_by = bound(2 * g.numel() * g.element_size()
                           + 2 * c.numel() * 4, 3.0 * g.numel(), dt)
        it = dict(iters=10, replays=3)
        out["rope"].append(dict(
            case="train_vjp", shape=list(g.shape), offset=0,
            dtype=str(dt).split(".")[-1], max_abs_err=ea, max_rel_err=er,
            ok=ok, ms=device_ms(lambda: rope.rope_rotate_forward(g, c, neg),
                                **it),
            wrapper_ms=wrapper_ms(lambda: rope.rope_rotate_forward(g, c, neg),
                                  iters=10),
            plain_ms=device_ms(lambda: rope.rope_rotate_plain(g, c, neg),
                               **it),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del x, g, got, want

    # Flash backward: the trainer's shape (recompute dK/dV), the stash
    # shape (batch 4), the trainer's sequence and head_dim in f32 (batch 1),
    # the flagship microbatch and its f32 gate on the flat (B*H, S, 1, D)
    # view the t-layout path launches on, and small ragged shapes; the dQ
    # kernel (with its stash except at the trainer's shape) and both dK/dV
    # kernels at each, against the plain versions of ops/flash_attention.py.
    dq_cases, dkv_cases, st_cases = [], [], []
    for name, (bb, ss, hh, dd), dt, big in (
            ("train", (b, s, h, hd), bf16, True),
            ("stash", (STASH_BATCH, s, h, hd), bf16, True),
            ("seq2048_f32", (1, s, h, hd), f32, True),
            ("ragged", (2, 100, 3, 64), bf16, False),
            ("ragged_f32", (2, 77, 2, 256), f32, False),
            ("flagship", (FLAGSHIP_MICRO * 4, s, 1, 512), bf16, True),
            ("flagship_gate_f32", (FLAGSHIP_GATE_BATCH * 4, 512, 1, 512),
             f32, True),
            ("ragged_d512", (2, 37, 1, 512), bf16, False)):
        q, k, v, do = (randn(bb, ss, hh, dd, dtype=dt) for _ in range(4))
        o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
        delta = flash.backward_delta(o, do)
        use_stash = name != "train"
        args = (q, k, v, do, lse, delta)
        with torch.no_grad():
            want_dq, want_p, want_ds = flash.flash_bwd_dq_plain(
                *args, stash=use_stash)
            want_dk, want_dv = flash.flash_bwd_dkv_plain(*args)
        dq, p_st, ds_st = flash.flash_bwd_dq(*args, stash=use_stash)
        dk_r, dv_r = flash.flash_bwd_dkv(*args)
        e_dq, e_dkv, e_st = (dict(max_abs_err=0.0, max_rel_err=0.0, ok=True)
                             for _ in range(3))

        def acc(entry, got, want):
            ea, er, ok = bwd_errors(got, want)
            entry["max_abs_err"] = max(entry["max_abs_err"], ea)
            entry["max_rel_err"] = max(entry["max_rel_err"], er)
            entry["ok"] = entry["ok"] and ok
        acc(e_dq, dq, want_dq)
        acc(e_dkv, dk_r, want_dk)
        acc(e_dkv, dv_r, want_dv)
        if use_stash:
            # The stash itself (zeros past the diagonal included), then
            # dK/dV from it.
            acc(e_dq, p_st, want_p)
            acc(e_dq, ds_st, want_ds)
            dk_s, dv_s = flash.flash_bwd_dkv_from_stash(q, k, v, do, p_st,
                                                        ds_st)
            acc(e_st, dk_s, want_dk)
            acc(e_st, dv_s, want_dv)
            del dk_s, dv_s
        del want_dq, want_p, want_ds, want_dk, want_dv, dk_r, dv_r, dq
        # Work this run's data needs: query row i sees keys [0, i].
        vis = bb * hh * ss * (ss + 1) // 2
        es = q.element_size()
        io_bytes = 4 * q.numel() * es + 2 * 4 * bb * hh * ss
        stash_w = 2 * bb * hh * ss * ss * es if use_stash else 0
        shape = dict(b=bb, s=ss, h=hh, d=dd)
        it = dict(iters=2, replays=2) if big else {}
        wit = 3 if big else 50
        lib = None
        if dt == bf16:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            lib = library_bwd_ms(
                lambda a, bk, c_: torch.nn.functional
                .scaled_dot_product_attention(a, bk, c_, is_causal=True),
                (qt, kt, vt), iters=5 if big else 20)
            del qt, kt, vt

        def case(entry, kernel, fn, plain, flops, bts):
            b_ms, b_by = bound(bts, flops, dt)
            entry.update(case=name, shape=shape, dtype=str(dt).split(".")[-1],
                         **flash.bwd_body(kernel, dd, dt),
                         rtol=BWD_RTOL[dt], atol_of_rms=BWD_ATOL_OF_RMS[dt],
                         ms=device_ms(fn, **it), wrapper_ms=wrapper_ms(
                             fn, iters=wit, warmup=2),
                         plain_ms=device_ms(plain, **it), bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib,
                         library_is="the whole backward (dQ, dK, dV)"
                         if lib is not None else None)
            return entry
        dq_cases.append(case(
            e_dq, flash.KERNEL_BWD_DQ,
            lambda: flash.flash_bwd_dq(*args, stash=use_stash),
            lambda: flash.flash_bwd_dq_plain(*args, stash=use_stash),
            3 * 2.0 * dd * vis, io_bytes + stash_w))
        if use_stash:     # what the recompute path's dQ costs at this shape
            e_dq["ms_without_stash"] = device_ms(
                lambda: flash.flash_bwd_dq(*args), **it)
        dkv_cases.append(case(
            e_dkv, flash.KERNEL_BWD_DKV, lambda: flash.flash_bwd_dkv(*args),
            lambda: flash.flash_bwd_dkv_plain(*args),
            4 * 2.0 * dd * vis, io_bytes + 2 * q.numel() * es))
        if use_stash:
            st_cases.append(case(
                e_st, flash.KERNEL_BWD_DKV_STASH,
                lambda: flash.flash_bwd_dkv_from_stash(
                    q, k, v, do, p_st, ds_st),
                lambda: flash.flash_bwd_dkv_from_stash_plain(
                    q, k, v, do, p_st, ds_st),
                2 * 2.0 * dd * vis, 4 * q.numel() * es + 2 * vis * es))
        del q, k, v, do, o, lse, delta, p_st, ds_st, args
        torch.cuda.empty_cache()
    out["flash_attention_bwd_dq"] = dq_cases
    out["flash_attention_bwd_dkv"] = dkv_cases
    out["flash_attention_bwd_dkv_stash"] = st_cases

    # The forward kernel at the trainer's shape (it runs 8 times a step) and
    # at the flagship's flat view (3 times a microbatch).
    for name, (bb, hh, dd) in (
            ("train_fwd", (b, h, hd)),
            ("flagship_fwd", (FLAGSHIP_MICRO * 4, 1, 512))):
        q, k, v = (randn(bb, s, hh, dd) for _ in range(3))
        ea, er, ok = errors(flash.flash_attention(q, k, v, True),
                            flash.flash_attention_plain(q, k, v, True),
                            BF16_ATOL, BF16_RTOL)
        vis = bb * hh * s * (s + 1) // 2
        fb_ms, fb_by = bound(4 * q.numel() * 2, 4.0 * dd * vis)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        it = dict(iters=2, replays=2)
        out["flash_attention"].append(dict(
            case=name, shape=dict(b=bb, sq=s, sk=s, h=hh, kh=hh, d=dd),
            q_offset=0, dtype="bfloat16",
            **flash_body(flash, q.dtype, dd), max_abs_err=ea,
            max_rel_err=er, ok=ok,
            ms=device_ms(lambda: flash.flash_attention(q, k, v, True), **it),
            wrapper_ms=wrapper_ms(lambda: flash.flash_attention(q, k, v, True),
                                  iters=3, warmup=1),
            plain_ms=device_ms(
                lambda: flash.flash_attention_plain(q, k, v, True), **it),
            bound_ms=fb_ms, bound_by=fb_by,
            library_ms=device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), **it)))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for name, cs in out.items():
        for c in cs:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


def ulp_errors(got: torch.Tensor, want: torch.Tensor):
    """Max abs difference of two bf16 tensors, and whether every entry is
    within one bf16 ulp (2^-7 of the value) of want's, or within the floor
    of CE_STAT_RTOL's note for entries near zero."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail("kernel output has non-finite values")
    diff = (g - w).abs()
    rms_w = float(torch.linalg.vector_norm(w)) / max(1, w.numel()) ** 0.5
    floor = BWD_ATOL_OF_RMS[torch.bfloat16] * rms_w
    return float(diff.max()), bool((diff <= w.abs() / 128 + floor).all())


def check_flagship_kernels(dev, rope, fused_ce, attn_mod, out: dict) -> dict:
    """The t-layout RoPE pair and the fused CE kernels at the flagship's
    shapes (microbatch 8 x 2048 tokens, 4 heads of 512, vocab 32768), the
    f32 gate's and small ragged ones; adds cases to `out`."""
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # RoPE into and out of the flat layout: bit for bit, as `rope` is.
    seq = TRAIN_DIMS["seq_len"]
    fwd_cases, inv_cases = [], []
    for name, (bb, ss, hh, dd), dt in (
            ("flagship", (FLAGSHIP_MICRO, seq, 4, 512), bf16),
            ("flagship_f32", (FLAGSHIP_MICRO, seq, 4, 512), f32),
            ("ragged", (3, 5, 2, 24), bf16)):
        fr = attn_mod.rope_frequencies(dd, ss, 10000.0, dev)
        c, sn = fr[..., 0].contiguous(), fr[..., 1].contiguous()
        x = randn(bb, ss, hh, dd, dtype=dt)
        g = randn(bb * hh, ss, dd, dtype=dt)
        es = x.element_size()
        b_ms, b_by = bound(2 * x.numel() * es + 2 * c.numel() * 4,
                           3.0 * x.numel(), dt)
        it = dict(iters=10, replays=3)
        for lst, fn, plain in (
                (fwd_cases, lambda: rope.rope_rotate_t_forward(x, c, sn),
                 lambda: rope.rope_rotate_t_plain(x, c, sn)),
                (inv_cases, lambda: rope.rope_rotate_t_inverse(g, c, sn, hh),
                 lambda: rope.rope_rotate_t_inv_plain(g, c, sn, hh))):
            got, want = fn(), plain()
            lst.append(dict(
                case=name, shape=[bb, ss, hh, dd], dtype=str(dt).split(".")[-1],
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ok=bool(torch.equal(got, want)), ms=device_ms(fn, **it),
                wrapper_ms=wrapper_ms(fn, iters=10), plain_ms=device_ms(
                    plain, **it), bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
        del x, g
    out["rope_t"], out["rope_t_inv"] = fwd_cases, inv_cases

    # Fused CE: the flagship microbatch, the f32 gate's rows, ragged N and
    # V (at D 128 and at the full D) and N < 64 with V 8.
    fwd_cases, bwd_cases = [], []
    for name, (n, d, v), dt in (
            ("flagship", (FLAGSHIP_MICRO * seq, 2048, 32768), bf16),
            ("flagship_gate_f32", (FLAGSHIP_GATE_BATCH * 512, 2048, 32768),
             f32),
            ("ragged", (300, 128, 264), bf16),
            ("ragged_full_d", (300, 2048, 264), bf16),
            ("tiny", (8, 256, 8), bf16)):
        h2 = randn(n, d, dtype=dt)
        head = (0.05 * randn(d, v, dtype=f32)).to(dt)
        t1 = torch.randint(0, v, (n,), generator=gen, device=dev)
        lse, gold, stash = fused_ce.fused_ce_forward(h2, head, t1)
        w_lse, w_gold, w_stash = fused_ce.fused_ce_forward_plain(h2, head, t1)
        rt = CE_STAT_RTOL[dt]
        ea, er, ok = errors(lse, w_lse, rt, rt)
        ea_g, er_g, ok_g = errors(gold, w_gold, rt, rt)
        ea_s, ok_s = ulp_errors(stash, w_stash)
        scale = torch.tensor([1.0 / n], device=dev)
        dlg, dh = fused_ce.fused_ce_backward(w_stash, head, w_lse, t1, scale)
        w_dlg, w_dh = fused_ce.fused_ce_backward_plain(w_stash, head, w_lse,
                                                       t1, scale)
        ea_d, ok_d = ulp_errors(dlg, w_dlg)
        ea_h, er_h, ok_h = bwd_errors(dh, w_dh)
        del lse, gold, stash, dlg, dh, w_dlg, w_dh
        big = n * v > 1 << 24
        it = dict(iters=2, replays=2) if big else {}
        wit = 3 if big else 20
        es = h2.element_size()
        shape = dict(n=n, d=d, v=v)
        fb_ms, fb_by = bound(n * d * es + d * v * es + 4 * n + 2 * n * v
                             + 8 * n, 2.0 * n * d * v, dt)
        hl = h2.detach().requires_grad_()
        fwd_body = fused_ce.body_report(fused_ce.KERNEL_FWD, dt)
        bwd_body = fused_ce.body_report(fused_ce.KERNEL_BWD, dt)
        if fwd_body["body"] != fused_ce.ce_body(dt) \
                or bwd_body["body"] != fused_ce.ce_body(dt):
            fail(f"fused CE bodies {fwd_body} / {bwd_body} at {dt}, the "
                 f"rule says {fused_ce.ce_body(dt)}")
        fwd_cases.append(dict(
            case=name, shape=shape, dtype=str(dt).split(".")[-1], **fwd_body,
            max_abs_err=max(ea, ea_g, ea_s), max_rel_err=max(er, er_g),
            lse_max_abs_err=ea, gold_max_abs_err=ea_g,
            stash_max_abs_err=ea_s, stat_rtol=rt, stash_within_one_ulp=ok_s,
            ok=ok and ok_g and ok_s,
            ms=device_ms(lambda: fused_ce.fused_ce_forward(h2, head, t1),
                         **it),
            wrapper_ms=wrapper_ms(
                lambda: fused_ce.fused_ce_forward(h2, head, t1), iters=wit,
                warmup=2),
            plain_ms=device_ms(
                lambda: fused_ce.fused_ce_forward_plain(h2, head, t1), **it),
            bound_ms=fb_ms, bound_by=fb_by,
            library_ms=device_ms(lambda: F.cross_entropy(
                (h2 @ head).float(), t1), **it),
            library_is="two calls: torch.matmul (logits) + F.cross_entropy"))
        bb_ms, bb_by = bound(2 * n * v * 2 + d * v * es + 8 * n
                             + n * d * 2, 2.0 * n * d * v + 5.0 * n * v, dt)
        bwd_cases.append(dict(
            case=name, shape=shape, dtype=str(dt).split(".")[-1], **bwd_body,
            max_abs_err=max(ea_d, ea_h), max_rel_err=er_h,
            dlg_max_abs_err=ea_d, dlg_within_one_ulp=ok_d,
            dh_max_abs_err=ea_h, ok=ok_d and ok_h,
            ms=device_ms(lambda: fused_ce.fused_ce_backward(
                w_stash, head, w_lse, t1, scale), **it),
            wrapper_ms=wrapper_ms(lambda: fused_ce.fused_ce_backward(
                w_stash, head, w_lse, t1, scale), iters=wit, warmup=2),
            plain_ms=device_ms(lambda: fused_ce.fused_ce_backward_plain(
                w_stash, head, w_lse, t1, scale), **it),
            bound_ms=bb_ms, bound_by=bb_by,
            library_ms=library_bwd_ms(
                lambda a: F.cross_entropy((a @ head).float(), t1), (hl,),
                iters=3 if big else 10),
            library_is="backward of torch.matmul + F.cross_entropy (two "
                       "calls) to the hidden, eager"))
        del h2, head, t1, w_lse, w_gold, w_stash, hl
        torch.cuda.empty_cache()
    out["fused_ce_fwd"], out["fused_ce_bwd"] = fwd_cases, bwd_cases
    for name in ("rope_t", "rope_t_inv", "fused_ce_fwd", "fused_ce_bwd"):
        for c in out[name]:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


def check_embed_relayout_kernels(dev, embed, relayout, out: dict) -> dict:
    """The embedding gather at the flagship microbatch (the loss's strided
    tokens[:, :-1] view of 8 x 2049 ids, the bf16 table of V 32768 x D
    2048), a decode step (8 ids), a prefill chunk (1 x 128), the trainer's
    f32 master table (rows rounded to bf16) and an f32 table with repeated
    ids, 0 and V - 1 (the f32 gates'); the relayout pair at the flagship
    microbatch (8, 2048, 4, 512) bf16, the flagship f32 gate's
    (1, 512, 4, 512) and a ragged shape. Each is held to its plain version
    bit for bit; adds cases to `out`."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional
    v, d = SERVE_DIMS["vocab_size"], SERVE_DIMS["d_model"]
    seq = TRAIN_DIMS["seq_len"]
    master = 0.02 * torch.randn((v, d), generator=gen, device=dev)
    table_bf = master.to(bf16)

    def ids(*shape, high=v):
        return torch.randint(0, high, shape, generator=gen, device=dev)
    repeats = ids(FLAGSHIP_GATE_BATCH, 512, high=64)
    repeats[0, 0], repeats[0, -1] = 0, v - 1
    cases = []
    for name, table, i, dt in (
            ("flagship", table_bf, ids(FLAGSHIP_MICRO, seq + 1)[:, :-1], bf16),
            ("decode", table_bf, ids(NUM_SLOTS), bf16),
            ("prefill", table_bf, ids(1, PREFILL_LEN), bf16),
            ("train_f32_master", master, ids(TRAIN_BATCH, seq + 1)[:, :-1],
             bf16),
            ("f32_repeats", master, repeats, f32)):
        scale = embed.embed_scale(d, dt)

        def kernel():
            return embed.embed_gather(table, i, scale, dt, True)

        def plain():
            return embed.embed_gather_plain(table, i, scale, dt, True)
        got, want = kernel(), plain()
        n = i.numel()
        b_ms, b_by = bound(n * d * (table.element_size() + got.element_size())
                           + n * i.element_size(), 1.0 * n * d, f32)
        it = dict(iters=10, replays=3) if n * d > 1 << 22 else {}
        cases.append(dict(
            case=name, shape=dict(ids=list(i.shape), v=v, d=d),
            table_dtype=str(table.dtype).split(".")[-1],
            dtype=str(dt).split(".")[-1], scale=scale,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ok=bool(torch.equal(got, want)), ms=device_ms(kernel, **it),
            wrapper_ms=wrapper_ms(kernel), plain_ms=device_ms(plain, **it),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda: F.embedding(i, table), **it),
            library_is="F.embedding (the gather alone)",
            eager_ms=device_ms(lambda: table.to(dt)[i] * scale, **it),
            eager_is="table.to(dtype)[ids] * scale, the model's expression "
                     "before the kernel"))
        del got, want
    out["embed_gather"] = cases

    to_cases, from_cases = [], []
    for name, (b, s, h, dd), dt in (
            ("flagship", (FLAGSHIP_MICRO, seq, 4, 512), bf16),
            ("flagship_gate_f32", (FLAGSHIP_GATE_BATCH, 512, 4, 512), f32),
            ("ragged", (3, 5, 2, 24), bf16)):
        x = torch.randn((b, s, h, dd), generator=gen, device=dev).to(dt)
        g = torch.randn((b * h, s, dd), generator=gen, device=dev).to(dt)
        b_ms, b_by = bound(2 * x.numel() * x.element_size(), 0.0, dt)
        it = dict(iters=10, replays=3) if x.numel() > 1 << 22 else {}
        for lst, kernel, plain, lib in (
                (to_cases, lambda: relayout.to_t_forward(x),
                 lambda: relayout.to_t_layout_plain(x),
                 lambda: x.transpose(1, 2).contiguous()),
                (from_cases, lambda: relayout.from_t_forward(g, b, h),
                 lambda: relayout.from_t_layout_plain(g, b, h),
                 lambda: g.view(b, h, s, dd).transpose(1, 2).contiguous())):
            got, want = kernel(), plain()
            lst.append(dict(
                case=name, shape=[b, s, h, dd], dtype=str(dt).split(".")[-1],
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ok=bool(torch.equal(got, want)), ms=device_ms(kernel, **it),
                wrapper_ms=wrapper_ms(kernel), plain_ms=device_ms(plain, **it),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(lib, **it),
                library_is="x.transpose(1, 2).contiguous() (or its inverse)"))
            del got, want
        del x, g
    out["relayout_to_t"], out["relayout_from_t"] = to_cases, from_cases
    del master, table_bf
    torch.cuda.empty_cache()
    for name in ("embed_gather", "relayout_to_t", "relayout_from_t"):
        for c in out[name]:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


# ---------------------------------------------------------------------------
# Phase 3: the engines at the serve dims
# ---------------------------------------------------------------------------


def _rope_t_plain(rope):
    def plain(x, cos, sin, heads, to_flat):
        return (rope.rope_rotate_t_plain(x, cos, sin) if to_flat
                else rope.rope_rotate_t_inv_plain(x, cos, sin, heads))
    return plain


@contextlib.contextmanager
def plain_versions(rms, rope, flash):
    """Route the kernel entry points, forward and backward, to their plain
    versions (the reference of this script; the package itself never does
    this)."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import (embed, fused_ce,
                                                         relayout)

    def relayout_plain(x, b, h, to_flat):
        return (relayout.to_t_layout_plain(x) if to_flat
                else relayout.from_t_layout_plain(x, b, h))
    names = ((embed, "_embed_gather_cuda", embed.embed_gather_plain),
             (relayout, "_relayout_cuda", relayout_plain),
             (rms, "_rms_norm_cuda", rms.rms_norm_plain),
             (rms, "_rms_norm_backward_cuda", rms.rms_norm_backward_plain),
             (rope, "_rope_rotate_cuda", rope.rope_rotate_plain),
             (rope, "_rope_t_cuda", _rope_t_plain(rope)),
             (flash, "_flash_attention_cuda", flash.flash_attention_plain),
             (flash, "_flash_attention_backward_cuda",
              flash.flash_attention_backward_plain),
             (fused_ce, "_fused_ce_forward_cuda",
              fused_ce.fused_ce_forward_plain),
             (fused_ce, "_fused_ce_backward_cuda",
              fused_ce.fused_ce_backward_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    for mod, name, plain in names:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def prefill_logits(decode, params, cfg, prompt, dev):
    """Last-position logits of `prompt` through forward_cached in
    prefill_len chunks, and the first chunk's full logits."""
    temp = decode.init_cache(cfg, 1, cfg.max_seq, dev)
    first = last = None
    for off in range(0, len(prompt), PREFILL_LEN):
        chunk = torch.as_tensor([prompt[off:off + PREFILL_LEN]], device=dev)
        logits, temp = decode.forward_cached(params, chunk, temp, off, cfg)
        first = logits[0] if first is None else first
        last = logits[0, -1]
    return first, last


def serve_params(dev, tf, serve):
    """The serve dims' config and bf16 params from seed 0 (as the serve
    main builds them), and the seconds the init took."""
    cfg = tf.TransformerConfig(**SERVE_DIMS, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = serve._finish_params(tf.init_params(gen, cfg), cfg, False)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def run_engine(dev, mods, cfg, params, init_s) -> dict:
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in range(N_REQUESTS)]
    prompts.append(rng.integers(0, cfg.vocab_size, LONG_PROMPT_LEN).tolist())

    eng = serving.ContinuousBatchEngine(
        params, cfg, num_slots=NUM_SLOTS, max_seq=cfg.max_seq,
        prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK, device=dev)
    warm = eng.submit(prompts[0][:16], 4)             # cuBLAS / first launches
    eng.run()
    if eng.result(warm).finish_reason != "length":
        fail(f"warm-up request: {eng.result(warm)}")
    eng = serving.ContinuousBatchEngine(
        params, cfg, num_slots=NUM_SLOTS, max_seq=cfg.max_seq,
        prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK, device=dev)

    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_launches = dict(kernels.launches)
    m = eng.metrics()
    want = expected_launches(cfg.n_layers, m["lifetime"])
    if engine_launches != want:
        fail(f"engine launches {engine_launches}, its chunks and steps "
             f"need {want}")
    for rid, p in zip(rids, prompts):
        r = eng.result(rid)
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            fail(f"request {rid} ended {r.finish_reason} with "
                 f"{len(r.tokens)} tokens: {r.error}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"request {rid} produced out-of-range token ids")
        if not all(np.isfinite(r.logprobs)):
            fail(f"request {rid} has non-finite logprobs")

    # Reference: the same forward with the plain versions in place of the
    # kernels, on the same weights and prompts (not counted as launches).
    first_k, _ = prefill_logits(decode, params, cfg, prompts[0], dev)
    with plain_versions(rms, rope, flash):
        first_p, _ = prefill_logits(decode, params, cfg, prompts[0], dev)
        plain_first = []
        for p in prompts:
            _, last = prefill_logits(decode, params, cfg, p, dev)
            top2 = torch.topk(last, 2).values
            plain_first.append((int(torch.argmax(last)),
                                float(top2[0] - top2[1])))
    if first_k.shape != (PREFILL_LEN, cfg.vocab_size) \
            or not torch.isfinite(first_k).all():
        fail(f"prefill logits shape {tuple(first_k.shape)} or non-finite")
    logits_err = float((first_k - first_p).abs().max())
    if logits_err > LOGITS_ATOL:
        fail(f"first prefill chunk logits differ from the plain path by "
             f"{logits_err} > {LOGITS_ATOL}")
    engine_first = [eng.result(r).tokens[0] for r in rids]
    if engine_first != [t for t, _ in plain_first]:
        fail(f"first tokens differ from the plain path: engine "
             f"{engine_first}, plain {plain_first}")
    del eng
    torch.cuda.empty_cache()
    return dict(
        config=dict(SERVE_DIMS, dtype="bfloat16", num_slots=NUM_SLOTS,
                    prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK),
        requests=len(rids), prompt_lens=[len(p) for p in prompts],
        new_tokens=NEW_TOKENS, wall_s=wall, init_s=init_s,
        tokens=m["tokens"], tokens_per_s=m["aggregate_tokens_per_s"],
        ttft_p50_ms=m["ttft_p50_ms"], ttft_p99_ms=m["ttft_p99_ms"],
        decode_ms_per_token_p50=m["token_lat_p50_ms"],
        decode_ms_per_token_p99=m["token_lat_p99_ms"],
        decode_steps=m["lifetime"]["decode_steps"],
        prefill_chunks=m["lifetime"]["prefill_chunks"],
        first_chunk_logits_max_abs_err=logits_err,
        logits_tolerance=LOGITS_ATOL,
        first_token_margins=[round(mg, 4) for _, mg in plain_first],
        launches=engine_launches)


def paged_requests(vocab: int):
    """The warm-up prompt (the shared prefix and one block of its own) and
    the phase's 9 prompts: 8 of the shared prefix plus a 32-token suffix,
    and one cold prompt of the same length."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    shared = [prefix + rng.integers(0, vocab, SUFFIX).tolist()
              for _ in range(N_REQUESTS)]
    cold = rng.integers(0, vocab, SHARED_PREFIX + SUFFIX).tolist()
    warm = prefix + rng.integers(0, vocab, KV_BLOCK_LEN).tolist()
    return warm, shared + [cold]


def new_engine(serving, params, cfg, dev, **kw):
    return serving.ContinuousBatchEngine(
        params, cfg, num_slots=NUM_SLOTS, max_seq=cfg.max_seq,
        prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK, device=dev, **kw)


def transcripts(eng, prompts):
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.run()
    return [eng.result(r) for r in rids]


@contextlib.contextmanager
def spying(targets):
    """Count calls of module attributes [(module, name), ...] while the
    block runs (the package itself is left unchanged)."""
    counts = {name: 0 for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_paged_engine(dev, mods, cfg, params) -> dict:
    """The paged engine at the serve defaults with pages of 16: a warm-up
    request publishes the shared prefix, then the 9 requests run with the
    launch counters and the spies on. Then the paged engine is held to the
    dense engine on the same requests: bf16 (count of identical
    transcripts, printed) and f32 (identical transcripts, a hard gate)."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    warm, prompts = paged_requests(cfg.vocab_size)
    eng = new_engine(serving, params, cfg, dev, kv_block_len=KV_BLOCK_LEN)
    w = eng.submit(warm, 4)
    eng.run()
    if eng.result(w).finish_reason != "length":
        fail(f"paged warm-up request: {eng.result(w)}")
    eng.release(w)
    before = eng.metrics_snapshot()
    peak = {"blocks_used": 0, "blocks_shared": 0}
    kernels.reset_launches()
    with spying([(serving, "_dense_attend"),
                 (paged, "paged_decode_attention_plain"),
                 (torch.nn.functional, "scaled_dot_product_attention")]) \
            as spied:
        t0 = time.perf_counter()
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        while eng.active:
            eng.step()
            kv = eng.metrics_snapshot()["kv_cache"]
            for k in peak:
                peak[k] = max(peak[k], kv[k])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    m = eng.metrics()
    life = {k: m["lifetime"][k] - before["lifetime"][k]
            for k in ("prefill_chunks", "decode_steps")}
    want = expected_launches(cfg.n_layers, life, paged=True)
    if launches != want:
        fail(f"paged engine launches {launches}, its chunks and steps need "
             f"{want}")
    if any(spied.values()):
        fail(f"the paged path reached another decode attention: {spied}")
    for rid in rids:
        r = eng.result(rid)
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            fail(f"paged request {rid} ended {r.finish_reason} with "
                 f"{len(r.tokens)} tokens: {r.error}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens) \
                or not all(np.isfinite(r.logprobs)):
            fail(f"paged request {rid} has out-of-range tokens or "
                 f"non-finite logprobs")
    kv = m["kv_cache"]
    matched = (kv["matched_tokens_total"]
               - before["kv_cache"]["matched_tokens_total"])
    prompt_tokens = (kv["prompt_tokens_total"]
                     - before["kv_cache"]["prompt_tokens_total"])
    if matched != N_REQUESTS * SHARED_PREFIX:
        fail(f"paged engine matched {matched} prompt tokens, want "
             f"{N_REQUESTS * SHARED_PREFIX}")
    paged_bf16 = [eng.result(r).tokens for r in rids]
    del eng
    dense_bf16 = [r.tokens for r in transcripts(
        new_engine(serving, params, cfg, dev), prompts)]

    # The f32 gate: the same weights cast to f32, full-f32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = cast_params(params, torch.float32)
    dense32 = transcripts(new_engine(serving, p32, cfg32, dev), prompts)
    paged32 = transcripts(new_engine(serving, p32, cfg32, dev,
                                     kv_block_len=KV_BLOCK_LEN), prompts)
    if [r.tokens for r in paged32] != [r.tokens for r in dense32]:
        diverged = [i for i, (a, b) in enumerate(zip(paged32, dense32))
                    if a.tokens != b.tokens]
        fail(f"f32 paged and dense transcripts differ (requests {diverged})")
    lp_err = max(float(np.max(np.abs(np.subtract(a.logprobs, b.logprobs))))
                 for a, b in zip(paged32, dense32))
    del p32, dense32, paged32
    torch.cuda.empty_cache()
    return dict(
        config=dict(SERVE_DIMS, dtype="bfloat16", num_slots=NUM_SLOTS,
                    prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK,
                    kv_block_len=KV_BLOCK_LEN,
                    kv_num_blocks=kv["blocks_total"] + 1),
        requests=len(rids), prompt_lens=[len(p) for p in prompts],
        shared_prefix=SHARED_PREFIX, new_tokens=NEW_TOKENS, wall_s=wall,
        tokens=m["tokens"], tokens_per_s=m["aggregate_tokens_per_s"],
        ttft_p50_ms=m["ttft_p50_ms"], ttft_p99_ms=m["ttft_p99_ms"],
        decode_ms_per_token_p50=m["token_lat_p50_ms"],
        decode_ms_per_token_p99=m["token_lat_p99_ms"],
        decode_steps=life["decode_steps"],
        prefill_chunks=life["prefill_chunks"],
        kv_cache=dict(peak_blocks_used=peak["blocks_used"],
                      peak_blocks_shared=peak["blocks_shared"],
                      blocks_cached=kv["blocks_cached"],
                      blocks_total=kv["blocks_total"],
                      deferrals=kv["deferrals_total"],
                      evictions=kv["evictions_total"],
                      matched_tokens=matched,
                      hit_rate=matched / prompt_tokens),
        prefix_hits=m["prefix_cache"]["hits"],
        f32_transcripts_identical=True, f32_logprob_max_abs_diff=lp_err,
        bf16_transcripts_identical=sum(a == b for a, b in
                                       zip(paged_bf16, dense_bf16)),
        bf16_requests=len(prompts), spied_calls=spied, launches=launches)


# ---------------------------------------------------------------------------
# Phase 4: the serve main, in-process
# ---------------------------------------------------------------------------


def post(port: int, body: dict, timeout: float = 300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def run_serve(serve, kernels, paged: bool = False) -> dict:
    """The serve main in-process, with the launch counters set to 0 just
    before it starts and read after it exits. Dense: three requests, one
    streamed. Paged (--kv-block-len 16): two requests sharing a 128-token
    prefix, the second served from the first one's pages."""
    stop = threading.Event()
    ready = {}
    got_port = threading.Event()

    def on_ready(port):
        ready["port"] = port
        got_port.set()

    rc = {}
    argv = ["--device", "cuda", "--port", "0", "--seed", "0"]
    if paged:
        argv += ["--kv-block-len", str(KV_BLOCK_LEN)]
    allocated_before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    th = threading.Thread(target=lambda: rc.update(rc=serve.main(
        argv, stop=stop, on_ready=on_ready)), daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        if not got_port.wait(600):
            fail("serve main did not come up")
        boot_s = time.perf_counter() - t0
        port = ready["port"]
        rng = np.random.default_rng(1)
        vocab = SERVE_DIMS["vocab_size"]
        if paged:
            prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
            prompts = [prefix + rng.integers(0, vocab, 16).tolist()
                       for _ in range(2)]
        else:
            prompts = [rng.integers(0, vocab, n).tolist()
                       for n in (16, PREFILL_LEN)]
        replies = []
        for prompt in prompts:
            with post(port, {"prompt": prompt, "maxNewTokens": 16,
                             "timeoutSeconds": 300}) as resp:
                r = json.loads(resp.read())
            if r.get("status") != "ok" or len(r["tokens"]) != 16:
                fail(f"/v1/generate reply: {r}")
            replies.append(r)
        ttfts = [r["ttftMs"] for r in replies]
        stream_lines = 0
        if not paged:
            prompt = rng.integers(0, vocab, 40).tolist()
            with post(port, {"prompt": prompt, "maxNewTokens": 24,
                             "stream": True, "timeoutSeconds": 300}) as resp:
                lines = [json.loads(x)
                         for x in resp.read().decode().splitlines()]
            final = lines[-1]
            streamed = [t for x in lines[:-1] for t in x["tokens"]]
            if final.get("status") != "ok" or streamed != final["tokens"] \
                    or len(streamed) != 24:
                fail(f"streamed /v1/generate: {lines}")
            ttfts.append(final["ttftMs"])
            stream_lines = len(lines)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as resp:
            if resp.status != 200:
                fail(f"/health answered {resp.status}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/metrics",
                                    timeout=30) as resp:
            metrics = json.loads(resp.read())["metrics"]
    finally:
        stop.set()
        th.join(120)
    if th.is_alive() or rc.get("rc") != 0:
        fail(f"serve main did not drain and exit 0: {rc}")
    # Read without a gc.collect(): what main() leaves on the card.
    retained_gb = (torch.cuda.memory_allocated() - allocated_before) / 1e9
    kv = metrics["kv_cache"]
    if paged and kv["matched_tokens_total"] < SHARED_PREFIX:
        fail(f"paged serve reused no prefix: {kv}")
    return dict(boot_s=boot_s, requests=len(ttfts), stream_lines=stream_lines,
                ttft_ms=ttfts, requests_completed=metrics["requests_completed"],
                lifetime=metrics["lifetime"],
                kv_cache={k: kv[k] for k in ("paged", "block_len",
                                             "matched_tokens_total",
                                             "prefix_hit_rate")},
                retained_after_return_gb=retained_gb,
                launches=dict(kernels.launches))


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------


def per_step_launches(n_layers: int, stash: bool, flagship: bool = False,
                      microbatches: int = 1, bf16: bool = True,
                      head_dim: int = 128) -> dict:
    """Kernel launches of one train step of the dense model: per microbatch
    one embedding gather, 2L+1 norms forward and backward, q and k rotated
    forward and back, L flash forward (in bf16 every one on the
    tensor-core body, in f32 none), dQ and dK/dV calls (the stash dK/dV
    kernel when the p/ds stash fits under its gate, else the recompute
    one; in bf16 dQ and the stash dK/dV on their tensor-core bodies at
    every head_dim, the recompute dK/dV at head_dim <= 128; in f32 none).
    On the flagship's paths the rotations
    are the t-layout pair (2L each way), v and the attention output pass
    the relayout pair (L each way forward, L each way back: 2L each) and
    the loss is one fused CE forward and backward (in bf16 both on their
    tensor-core bodies, in f32 neither); elsewhere 4L RoPE launches."""
    want = {"embed_gather": 1,
            "rms_norm": 2 * n_layers + 1, "rms_norm_bwd": 2 * n_layers + 1,
            "flash_attention": n_layers, "flash_attention_bwd_dq": n_layers,
            ("flash_attention_bwd_dkv_stash" if stash
             else "flash_attention_bwd_dkv"): n_layers}
    if bf16:
        want["flash_attention_wgmma"] = n_layers
        want["flash_attention_bwd_dq_wgmma"] = n_layers
        if stash:
            want["flash_attention_bwd_dkv_stash_wgmma"] = n_layers
        elif head_dim <= 128:
            want["flash_attention_bwd_dkv_wgmma"] = n_layers
    if flagship:
        want.update(rope_t=2 * n_layers, rope_t_inv=2 * n_layers,
                    relayout_to_t=2 * n_layers, relayout_from_t=2 * n_layers,
                    fused_ce_fwd=1, fused_ce_bwd=1)
        if bf16:
            want.update(fused_ce_fwd_wgmma=1, fused_ce_bwd_wgmma=1)
    else:
        want["rope"] = 4 * n_layers
    return {k: n * microbatches for k, n in want.items()}


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}/{k}")]
    return [prefix]


def run_train_gate(dev, mods, dims=GATE_DIMS, batch=GATE_BATCH,
                   flagship=False) -> dict:
    """f32 at full width (the trainer's: 2 layers, batch 2, seq 512; the
    flagship's: 1 layer, batch 1, seq 512): the model loss and every
    gradient leaf through the kernels against the same step through the
    plain versions, same weights and batch. The kernel step runs twice:
    with the p/ds stash (it fits under its gate here) and with the gate set
    to 0, so the recompute dK/dV kernel runs too."""
    kernels, rms, rope, flash, tf, trainer = mods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tf.TransformerConfig(**dims, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = tf.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=gen, device=dev)

    def loss_and_grads():
        p = trainer.tree_map(lambda t: t.detach().clone().requires_grad_(),
                             params)
        loss, _ = tf.loss_fn(p, toks, cfg)
        grads = torch.autograd.grad(loss, trainer.tree_leaves(p))
        return loss.item(), grads

    runs = {}
    limit = flash.PDS_STASH_LIMIT_BYTES
    for path, gate in (("stash", limit), ("recompute", 0)):
        flash.PDS_STASH_LIMIT_BYTES = gate
        try:
            kernels.reset_launches()
            runs[path] = loss_and_grads() + (dict(kernels.launches),)
        finally:
            flash.PDS_STASH_LIMIT_BYTES = limit
    kernels.reset_launches()
    with plain_versions(rms, rope, flash):
        p_loss, p_grads = loss_and_grads()
    if dict(kernels.launches):
        fail("the plain-version reference step launched kernels")
    out = dict(config=dict(dims, batch=batch, dtype="float32"),
               plain_loss=p_loss, loss_rtol=GATE_LOSS_RTOL,
               leaf_rtol=GATE_LEAF_RTOL)
    for path, (k_loss, k_grads, launches) in runs.items():
        want = per_step_launches(cfg.n_layers, stash=path == "stash",
                                 flagship=flagship, bf16=False)
        if any(launches.get(k, 0) for k in WGMMA_COUNTERS.values()):
            fail(f"f32 gate step ({path}) ran a bf16 tensor-core flash "
                 f"body: {launches}")
        if launches != want:
            fail(f"f32 gate step ({path}) launched {launches}, want {want}")
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        leaf_err = {}
        for name, a, b in zip(leaf_names(params), k_grads, p_grads):
            leaf_err[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
            if not torch.isfinite(a).all():
                fail(f"f32 gate ({path}): gradient {name} has non-finite "
                     f"values")
        worst = max(leaf_err, key=leaf_err.get)
        if not loss_rel <= GATE_LOSS_RTOL or leaf_err[worst] >= GATE_LEAF_RTOL:
            fail(f"f32 gate ({path}): loss {k_loss} vs plain {p_loss} (rel "
                 f"{loss_rel}), worst leaf {worst} rel norm error "
                 f"{leaf_err[worst]}")
        out[path] = dict(loss=k_loss, loss_rel_err=loss_rel,
                         leaf_rel_norm_err=leaf_err, worst_leaf=worst,
                         launches=launches)
    del params, runs, p_grads
    torch.cuda.empty_cache()
    return out


def run_trainer(trainer_cli, kernels, batch: int, steps: int,
                stash: bool) -> dict:
    """The port's trainer main in-process at its defaults (bf16 on the
    card), with the launch counters set to 0 just before it starts and
    read after every step and when it returns."""
    freed_gb = collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    snaps, losses, gnorms = [], [], []

    def on_step(i, metrics):
        snaps.append(dict(kernels.launches))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    argv = ["--device", "cuda", "--steps", str(steps), "--batch-size",
            str(batch), "--seed", "0"]
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = trainer_cli.main(argv, callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"trainer main {argv} exited {rc}")
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    final = lines[-1] if lines else {}
    if not final.get("final") or final.get("steps") != steps - 1:
        fail(f"trainer main printed no final line for {steps} steps: "
             f"{buf.getvalue()[-2000:]}")
    want = per_step_launches(TRAIN_DIMS["n_layers"], stash, head_dim=TRAIN_DIMS[
        "d_model"] // TRAIN_DIMS["n_heads"])
    prev = {}
    per_step = []
    for snap in snaps:
        delta = {k: n - prev.get(k, 0) for k, n in snap.items()
                 if n - prev.get(k, 0)}
        per_step.append(delta)
        prev = snap
        if delta != want:
            fail(f"trainer step launched {delta}, want {want} "
                 f"(batch {batch})")
    if launches != snaps[-1]:
        fail("the trainer launched kernels outside its steps")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail(f"trainer losses {losses} or grad norms {gnorms} not finite")
    return dict(config=dict(TRAIN_DIMS, batch=batch, dtype="bfloat16"),
                argv=argv, steps=steps, wall_s=wall,
                step_ms=final["avg_step_s"] * 1e3,
                tokens_per_s=final["tokens_per_s"],
                achieved_tflops=final["achieved_tflops"],
                mfu_pct=final["mfu_pct"], mfu_peak_tflops=989.0,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9, freed_by_gc_collect_gb=freed_gb,
                losses=losses, grad_norms=gnorms,
                launches_per_step=per_step[0], launches=launches)


def collect_garbage() -> float:
    """gc.collect() before a phase's peak reset, so garbage that earlier
    phases left in reference cycles does not count; returns the GB of
    device memory it freed."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return (before - torch.cuda.memory_allocated()) / 1e9


def run_flagship(kernels, trainer, flagship) -> dict:
    """train.trainer.train_loop on the flagship configuration at full width
    and depth (bf16 on the card), cut to batch 32 (4 microbatches of 8) a
    step; launch counters set to 0 just before it and read after every
    step and when it returns."""
    freed_gb = collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    model_cfg, train_cfg = flagship.flagship_configs(
        batch_size=FLAGSHIP_BATCH, grad_accum=FLAGSHIP_ACCUM)
    snaps, losses, gnorms = [], [], []

    def on_step(i, metrics):
        snaps.append(dict(kernels.launches))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = trainer.train_loop(model_cfg, train_cfg, num_steps=FLAGSHIP_STEPS,
                             callback=on_step, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    want = per_step_launches(model_cfg.n_layers, stash=True, flagship=True,
                             microbatches=FLAGSHIP_ACCUM,
                             head_dim=model_cfg.d_model // model_cfg.n_heads)
    prev, per_step = {}, []
    for snap in snaps:
        delta = {k: n - prev.get(k, 0) for k, n in snap.items()
                 if n - prev.get(k, 0)}
        per_step.append(delta)
        prev = snap
        if delta != want:
            fail(f"flagship step launched {delta}, want {want}")
    if len(snaps) != FLAGSHIP_STEPS or launches != snaps[-1]:
        fail("the flagship run launched kernels outside its steps")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail(f"flagship losses {losses} or grad norms {gnorms} not finite")
    return dict(config=dict(model=dict(
                    vocab_size=model_cfg.vocab_size,
                    d_model=model_cfg.d_model, n_layers=model_cfg.n_layers,
                    n_heads=model_cfg.n_heads, d_ff=model_cfg.d_ff,
                    ce_chunk=model_cfg.ce_chunk,
                    ce_cache_logits=model_cfg.ce_cache_logits),
                    seq_len=train_cfg.seq_len, batch=train_cfg.batch_size,
                    grad_accum=train_cfg.grad_accum,
                    microbatch=train_cfg.microbatch_size, dtype="bfloat16"),
                steps=FLAGSHIP_STEPS, timed_steps=res["steps"], wall_s=wall,
                step_ms=res["avg_step_s"] * 1e3,
                tokens_per_s=res["tokens_per_s"],
                achieved_tflops=res["achieved_tflops"],
                mfu_pct=res["mfu_pct"], mfu_peak_tflops=989.0,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9, freed_by_gc_collect_gb=freed_gb,
                losses=losses, grad_norms=gnorms,
                launches_per_step=per_step[0], launches=launches)


# ---------------------------------------------------------------------------
# Phase 6: where a step's device time goes
# ---------------------------------------------------------------------------


def profile_window(run) -> dict:
    """torch.profiler over one training step. `run(on_step)` trains two
    steps and calls on_step(i, metrics) after each (a step ends in a host
    read of its loss); the window opens after step 0 and closes after step
    1, outside every timed phase. Returns the ten device operations with
    the most self time under the profiler's names, the flash forward's
    total, the split of the flash backward, fused CE and RMSNorm kernels,
    and the device's idle share: 1 - (union of device activity) /
    (the window's host wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, metrics):
        torch.cuda.synchronize()
        if i == 0:
            prof.start()
            marks["start"] = time.perf_counter()
        elif i == 1:
            marks["end"] = time.perf_counter()
            prof.stop()
    rc = run(on_step)
    if isinstance(rc, int) and rc != 0:
        fail(f"profiled run exited {rc}")
    window_ms = (marks["end"] - marks["start"]) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > reach:
            busy_us += t1 - max(t0, reach)
            reach = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_ms=window_ms, device_ops=len(spans),
                device_busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / 1e3 / window_ms,
                flash_fwd_ms=sum(ms for n, ms in by_name.items()
                                 if "flash_fwd" in n),
                fused_ce_ms={k: sum(ms for n, ms in by_name.items() if k in n)
                             for k in ("ce_wgmma_kernel<true>",
                                       "ce_wgmma_kernel<false>",
                                       "ce_dlg_kernel", "ce_combine_kernel",
                                       "ce_fwd_kernel", "ce_bwd_kernel")},
                flash_bwd_ms={k: sum(ms for n, ms in by_name.items() if k in n)
                              for k in ("flash_bwd_dq_kernel",
                                        "flash_bwd_dq_wgmma",
                                        "flash_bwd_dq_wide_wgmma",
                                        "flash_bwd_dkv_kernel",
                                        "flash_bwd_dkv_wgmma",
                                        "flash_bwd_dkv_stash_kernel",
                                        "flash_bwd_dkv_stash_wgmma")},
                rms_ms={k: sum(ms for n, ms in by_name.items() if k in n)
                        for k in ("rms_norm_fwd_kernel", "rms_norm_bwd_kernel",
                                  "rms_dw_finalize_kernel")},
                top=[dict(name=n[:160], self_ms=ms, share=ms / window_ms)
                     for n, ms in top])


def profile_steps(trainer_cli, trainer, flagship) -> dict:
    """The profiler window on a step of the trainer main at its defaults
    and on a flagship step of one microbatch of 8 (grad_accum 1)."""
    collect_garbage()
    argv = ["--device", "cuda", "--steps", "2", "--batch-size",
            str(TRAIN_BATCH), "--seed", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        train = profile_window(
            lambda cb: trainer_cli.main(argv, callback=cb))
    collect_garbage()
    model_cfg, train_cfg = flagship.flagship_configs(
        batch_size=FLAGSHIP_MICRO, grad_accum=1)
    micro = profile_window(lambda cb: trainer.train_loop(
        model_cfg, train_cfg, num_steps=2, callback=cb, device="cuda"))
    collect_garbage()
    return {"train_step": train, "flagship_microbatch": micro}


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as trainer_cli
    from k8s_gpu_workload_enhancer_tpu_torch.models import (
        decode, serving, transformer as tf)
    from k8s_gpu_workload_enhancer_tpu_torch.ops import (
        attention as attn_mod, embed, flash_attention as flash, fused_ce,
        kernels, paged_attention as paged, relayout, rms, rope)
    from k8s_gpu_workload_enhancer_tpu_torch.train import flagship, trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    # Every f32 product in full f32 (the plain versions' references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_lib = kernels.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "per_library_s": per_lib}), flush=True)
    for name in kernels.SIGNATURES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    regs = {k: int(re.search(rf"{k} = (\d+);", src).group(1))
            for k in ("kProducerRegs", "kConsumerRegs")}
    print(json.dumps({"flash_attention_build": {
        "build_s": per_lib["flash_attention"],
        "kernels": ptxas_entries(kernels.build_log("flash_attention")),
        "setmaxnreg": regs,
        "bodies": [dict(dtype=str(dt).split(".")[-1], d=d,
                        **flash_body(flash, dt, d))
                   for dt, d in ((torch.bfloat16, 128),
                                 (torch.bfloat16, 512),
                                 (torch.float32, 512))]}}), flush=True)

    print(json.dumps({"flash_attention_bwd_build": {
        "build_s": per_lib["flash_attention_bwd"],
        "kernels": ptxas_entries(kernels.build_log("flash_attention_bwd")),
        "bodies": [dict(kernel=k, dtype=str(dt).split(".")[-1], d=d,
                        **flash.bwd_body(k, d, dt))
                   for k in (flash.KERNEL_BWD_DQ, flash.KERNEL_BWD_DKV,
                             flash.KERNEL_BWD_DKV_STASH)
                   for dt, d in ((torch.bfloat16, 128), (torch.bfloat16, 512),
                                 (torch.float32, 128))]}}), flush=True)
    print(json.dumps({"rms_build": {
        "build_s": per_lib["rms"],
        "kernels": ptxas_entries(kernels.build_log("rms"))}}), flush=True)
    print(json.dumps({"fused_ce_build": {
        "build_s": per_lib["fused_ce"],
        "kernels": ptxas_entries(kernels.build_log("fused_ce")),
        "setmaxnreg": {k: int(re.search(rf"{k} = (\d+);", (
            kernels.CSRC / "fused_ce.cu").read_text()).group(1))
            for k in ("kProducerRegs", "kConsumerRegs")},
        "bodies": [dict(kernel=k, dtype=str(dt).split(".")[-1],
                        **fused_ce.body_report(k, dt))
                   for k in (fused_ce.KERNEL_FWD, fused_ce.KERNEL_BWD)
                   for dt in (torch.bfloat16, torch.float32)]}}), flush=True)
    results = {"kernels": check_kernels(dev, rms, rope, flash, paged,
                                        attn_mod)}
    check_train_kernels(dev, rms, rope, flash, attn_mod, results["kernels"])
    check_flagship_kernels(dev, rope, fused_ce, attn_mod, results["kernels"])
    check_embed_relayout_kernels(dev, embed, relayout, results["kernels"])
    print(json.dumps({"kernel_checks": results["kernels"]}), flush=True)
    mods = (kernels, rms, rope, flash, paged, tf, decode, serving, serve)
    cfg, params, init_s = serve_params(dev, tf, serve)
    n_layers = SERVE_DIMS["n_layers"]
    # The main paths; each phase sets the launch counters to 0 just before
    # it and reads them just after.
    results["engine"] = run_engine(dev, mods, cfg, params, init_s)
    print(json.dumps({"engine": results["engine"]}), flush=True)
    results["serve"] = run_serve(serve, kernels)
    print(json.dumps({"serve": results["serve"]}), flush=True)
    results["paged_engine"] = run_paged_engine(dev, mods, cfg, params)
    print(json.dumps({"paged_engine": results["paged_engine"]}), flush=True)
    del params
    torch.cuda.empty_cache()
    results["paged_serve"] = run_serve(serve, kernels, paged=True)
    print(json.dumps({"paged_serve": results["paged_serve"]}), flush=True)
    for phase in ("serve", "paged_serve"):
        got = results[phase]["launches"]
        want = expected_launches(n_layers, results[phase]["lifetime"],
                                 paged=phase == "paged_serve")
        if got != want:
            fail(f"{phase} launches {got}, its chunks and steps need {want}")
    gate_mods = (kernels, rms, rope, flash, tf, trainer)
    results["train_gate_f32"] = run_train_gate(dev, gate_mods)
    print(json.dumps({"train_gate_f32": results["train_gate_f32"]}),
          flush=True)
    results["flagship_gate_f32"] = run_train_gate(
        dev, gate_mods, FLAGSHIP_GATE_DIMS, FLAGSHIP_GATE_BATCH, flagship=True)
    print(json.dumps({"flagship_gate_f32": results["flagship_gate_f32"]}),
          flush=True)
    results["train"] = run_trainer(trainer_cli, kernels, TRAIN_BATCH,
                                   TRAIN_STEPS, stash=False)
    print(json.dumps({"train": results["train"]}), flush=True)
    results["train_stash"] = run_trainer(trainer_cli, kernels, STASH_BATCH,
                                         STASH_STEPS, stash=True)
    print(json.dumps({"train_stash": results["train_stash"]}), flush=True)
    results["flagship"] = run_flagship(kernels, trainer, flagship)
    print(json.dumps({"flagship": results["flagship"]}), flush=True)
    results["profile"] = profile_steps(trainer_cli, trainer, flagship)
    print(json.dumps({"profile": results["profile"]}), flush=True)

    serving_phases = ("engine", "serve", "paged_engine", "paged_serve")
    train_phases = ("train", "train_stash")
    every = serving_phases + train_phases
    paths = {"embed_gather": every + ("flagship",),
             "rms_norm": every + ("flagship",), "rope": every,
             "flash_attention": every + ("flagship",),
             "paged_decode": ("paged_engine", "paged_serve"),
             "rms_norm_bwd": train_phases + ("flagship",),
             "flash_attention_bwd_dq": train_phases + ("flagship",),
             "flash_attention_bwd_dkv": ("train",),
             "flash_attention_bwd_dkv_stash": ("train_stash", "flagship"),
             "rope_t": ("flagship",), "rope_t_inv": ("flagship",),
             "fused_ce_fwd": ("flagship",), "fused_ce_bwd": ("flagship",),
             "relayout_to_t": ("flagship",), "relayout_from_t": ("flagship",)}
    # Every bf16 flash and fused CE launch of every phase ran a tensor-core
    # body: the flash forward, dQ and the stash dK/dV at every head_dim, the
    # recompute dK/dV of the train phase (head_dim 128), the fused CE
    # forward and backward of the flagship; none in the f32 gates.
    bodies = {}
    for kernel, counter in WGMMA_COUNTERS.items():
        for phase in paths[kernel]:
            n = results[phase]["launches"]
            got = [n.get(counter, 0), n.get(kernel, 0)]
            bodies[f"{phase}/{kernel}"] = got
            if got[0] != got[1]:
                fail(f"{phase}: {got[0]} of {got[1]} {kernel} launches ran "
                     f"the wgmma body, want all")
    for gate in ("train_gate_f32", "flagship_gate_f32"):
        for path in ("stash", "recompute"):
            n = results[gate][path]["launches"]
            for kernel, counter in WGMMA_COUNTERS.items():
                bodies[f"{gate}/{path}/{kernel}"] = [n.get(counter, 0),
                                                     n.get(kernel, 0)]
                if n.get(counter, 0):
                    fail(f"{gate} ({path}) ran the bf16 wgmma body of "
                         f"{kernel}")
    print(json.dumps({"bodies_wgmma_of_all": bodies}), flush=True)
    main_path_launches = {}
    for name, on in paths.items():
        for phase in on:
            n = results[phase]["launches"].get(name, 0)
            if n <= 0:
                fail(f"kernel {name} never launched in the {phase} phase")
            main_path_launches[name] = main_path_launches.get(name, 0) + n
    entries = []
    port, ref = ("k8s_gpu_workload_enhancer_tpu_torch/csrc/",
                 "k8s_gpu_workload_enhancer_tpu/ops/")
    meta = {
        "rms_norm": ("rms.cu", "rms_pallas.py:41"),
        "rope": ("rope.cu", "rope_pallas.py:30"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:125"),
        "paged_decode": ("paged_decode.cu", "flash_attention.py:809"),
        "rms_norm_bwd": ("rms.cu", "rms_pallas.py:48"),
        "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                                   "flash_attention.py:299"),
        "flash_attention_bwd_dkv_stash": ("flash_attention_bwd.cu",
                                          "flash_attention.py:377"),
        "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                    "flash_attention.py:418"),
        "rope_t": ("rope.cu", "rope_pallas.py:111"),
        "rope_t_inv": ("rope.cu", "rope_pallas.py:121"),
        "fused_ce_fwd": ("fused_ce.cu", "fused_ce.py:87"),
        "fused_ce_bwd": ("fused_ce.cu", "fused_ce.py:175"),
        "embed_gather": ("embed.cu", "embed_pallas.py:61"),
        "relayout_to_t": ("relayout.cu", "relayout.py:56"),
        "relayout_from_t": ("relayout.cu", "relayout.py:63"),
    }
    fwd_tol = {"atol": BF16_ATOL, "rtol": BF16_RTOL}
    bwd_tol = {"rtol": {str(k).split(".")[-1]: v for k, v in BWD_RTOL.items()},
               "atol_of_rms": {str(k).split(".")[-1]: v
                               for k, v in BWD_ATOL_OF_RMS.items()}}
    ce_tol = {"fused_ce_fwd": {"lse_gold_rtol": {
                  str(k).split(".")[-1]: v for k, v in CE_STAT_RTOL.items()},
                  "stash": "one bf16 ulp"},
              "fused_ce_bwd": {"dlg": "one bf16 ulp", "dh": bwd_tol}}
    for name, (source, replaces) in meta.items():
        cases = results["kernels"][name]
        main = cases[0]     # the path's own shape: prefill chunk, decode
        extra = {k: main[k] for k in ("dense_sdpa_ms", "eager_ms",  # step,
                                      "eager_is", "library_is")  # train step
                 if k in main}
        if name in WGMMA_COUNTERS:
            extra["wgmma_launches"] = sum(
                results[phase]["launches"].get(WGMMA_COUNTERS[name], 0)
                for phase in paths[name])
        for k in ("body", "instance", "dynamic_smem_bytes"):
            if k in main:
                extra[k] = main[k]
        exact = name.startswith(("rope_t", "embed", "relayout"))
        tolerance = (ce_tol[name] if name in ce_tol else
                     {"forward": "bit for bit"} if exact
                     else {"backward": bwd_tol} if "bwd" in name else
                     {"forward": fwd_tol, "vjp": bwd_tol} if name == "rope"
                     else {"forward": fwd_tol})
        entries.append(dict(
            name=name, route="cuda", source=port + source,
            replaces=ref + replaces, launches=main_path_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            tolerance=tolerance, ms=main["ms"],
            wrapper_ms=main["wrapper_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], **extra, shape=main["shape"],
            cases=cases))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
