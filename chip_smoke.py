"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the port's serving path at the default serve dims (vocab 32768,
d_model 2048, 3 layers, 4 heads of 512, d_ff 16384, max_seq 256, 8 slots,
prefill_len 128, decode_chunk 8) from a seeded random init in bf16:

  1. prints the card's name and power limit (nvidia-smi) and builds every
     kernel from csrc/, one nvcc per source, all at once;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the serving paths give it (and small ragged shapes), and times
     on the device (50 calls in one CUDA graph, replayed) the kernel, the
     plain version and, where one PyTorch call computes the same function,
     that call; the wrapper's eager per-call rate, which includes the
     host's cost of issuing it, is reported apart. The paged decode kernel
     is also timed beside `scaled_dot_product_attention` over the same rows
     laid out as a contiguous cache (`dense_sdpa_ms`, a yardstick: that
     call does no table walk, so it is not the same function);
  3. runs the main paths, each with the launch counters set to 0 just
     before it and read just after: the dense engine on 8 requests of
     128-token prompts plus one of 160 (chunked prefill at offset 128); the
     serve main in-process answering three POST /v1/generate (one
     streamed); the paged engine (kv_block_len 16) on 8 requests of 160
     tokens sharing a 128-token prefix plus one cold request of 160, after
     a warm-up that published the prefix, so 8 of the 9 start from pool
     pages; and the paged serve main answering two requests that share a
     128-token prefix. Every phase must launch exactly the kernels its
     prefill chunks and decode steps need (on the paged path the paged
     decode kernel L times a step, and never the dense decode attention).
     The dense phase's first prefill chunk and first tokens are checked
     against the plain versions; the paged engine is held to the dense
     engine: identical greedy transcripts in f32 on the same weights (a
     hard gate), and the count of identical ones in bf16, printed;
  4. prints the {"kernels": [...]} line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failed phase exits non-zero before the result line. Without a CUDA card
it exits 1 at once.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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

# Kernel vs plain version in bf16: both round once from f32, so they differ
# by at most a couple of bf16 ulps (2^-8 relative) where their f32 sums are
# taken in another order.
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# First prefill chunk's f32 logits, kernels vs plain versions: bf16
# activations through 3 layers; a one-ulp flip upstream moves a logit by
# about 1e-2 at these magnitudes.
LOGITS_ATOL = 0.1


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
    runs 2L+1 norms, 2L RoPE rotations (q and k) and L flash calls; every
    decode step 2L+1 norms and, on the paged engine, L paged decode calls
    (dense decode RoPE and attention are plain torch)."""
    chunks, steps = lifetime["prefill_chunks"], lifetime["decode_steps"]
    want = {"rms_norm": (2 * n_layers + 1) * (chunks + steps),
            "rope": 2 * n_layers * chunks,
            "flash_attention": n_layers * chunks}
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dev, rms, rope, flash, paged, attn_mod) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    d, h, hd = SERVE_DIMS["d_model"], SERVE_DIMS["n_heads"], 2048 // 4
    out = {}

    # RMSNorm: prefill rows, decode rows, and a ragged small shape.
    cases = []
    w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(torch.bfloat16)
    for rows, width in ((PREFILL_LEN, d), (NUM_SLOTS, d), (5, 203)):
        x = randn(rows, width)
        ww = w if width == d else (1.0 + 0.1 * randn(width)).to(torch.bfloat16)
        got = rms.rms_norm(x, ww)
        want = rms.rms_norm_plain(x, ww)
        ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
        bts = 2 * x.numel() * 2 + ww.numel() * 2
        b_ms, b_by = bound(bts, 4.0 * x.numel())
        lib_ms = device_ms(lambda: torch.nn.functional.rms_norm(
            x, (width,), ww, 1e-6))
        cases.append(dict(shape=[rows, width], dtype="bfloat16",
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
                          q_offset=q_off, dtype="bfloat16", max_abs_err=ea,
                          max_rel_err=er, ok=ok,
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
# Phase 3: the engines at the serve dims
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_versions(rms, rope, flash):
    """Route the kernel entry points to their plain versions (the reference
    forward of this script; the package itself never does this)."""
    saved = (rms._rms_norm_cuda, rope._rope_rotate_cuda,
             flash._flash_attention_cuda)
    rms._rms_norm_cuda = rms.rms_norm_plain
    rope._rope_rotate_cuda = rope.rope_rotate_plain
    flash._flash_attention_cuda = flash.flash_attention_plain
    try:
        yield
    finally:
        (rms._rms_norm_cuda, rope._rope_rotate_cuda,
         flash._flash_attention_cuda) = saved


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
    kv = metrics["kv_cache"]
    if paged and kv["matched_tokens_total"] < SHARED_PREFIX:
        fail(f"paged serve reused no prefix: {kv}")
    return dict(boot_s=boot_s, requests=len(ttfts), stream_lines=stream_lines,
                ttft_ms=ttfts, requests_completed=metrics["requests_completed"],
                lifetime=metrics["lifetime"],
                kv_cache={k: kv[k] for k in ("paged", "block_len",
                                             "matched_tokens_total",
                                             "prefix_hit_rate")},
                launches=dict(kernels.launches))


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
    from k8s_gpu_workload_enhancer_tpu_torch.models import (
        decode, serving, transformer as tf)
    from k8s_gpu_workload_enhancer_tpu_torch.ops import (
        attention as attn_mod, flash_attention as flash, kernels,
        paged_attention as paged, rms, rope)

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

    t0 = time.perf_counter()
    per_lib = kernels.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "per_library_s": per_lib}), flush=True)
    for name in kernels.SIGNATURES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    results = {"kernels": check_kernels(dev, rms, rope, flash, paged,
                                        attn_mod)}
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

    phases = ("engine", "serve", "paged_engine", "paged_serve")
    paths = {"rms_norm": phases, "rope": phases, "flash_attention": phases,
             "paged_decode": ("paged_engine", "paged_serve")}
    main_path_launches = {}
    for name, on in paths.items():
        for phase in on:
            n = results[phase]["launches"].get(name, 0)
            if n <= 0:
                fail(f"kernel {name} never launched in the {phase} phase")
            main_path_launches[name] = main_path_launches.get(name, 0) + n
    entries = []
    meta = {
        "rms_norm": ("k8s_gpu_workload_enhancer_tpu_torch/csrc/rms.cu",
                     "k8s_gpu_workload_enhancer_tpu/ops/rms_pallas.py:41"),
        "rope": ("k8s_gpu_workload_enhancer_tpu_torch/csrc/rope.cu",
                 "k8s_gpu_workload_enhancer_tpu/ops/rope_pallas.py:30"),
        "flash_attention": (
            "k8s_gpu_workload_enhancer_tpu_torch/csrc/flash_attention.cu",
            "k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py:125"),
        "paged_decode": (
            "k8s_gpu_workload_enhancer_tpu_torch/csrc/paged_decode.cu",
            "k8s_gpu_workload_enhancer_tpu/ops/flash_attention.py:809"),
    }
    for name, (source, replaces) in meta.items():
        cases = results["kernels"][name]
        main = cases[0]              # the prefill-chunk / decode-step shape
        extra = ({"dense_sdpa_ms": main["dense_sdpa_ms"]}
                 if "dense_sdpa_ms" in main else {})
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_path_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            atol=BF16_ATOL, rtol=BF16_RTOL, ms=main["ms"],
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
