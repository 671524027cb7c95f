"""The int8 KV cache on the port, held to the JAX package.

- `kv_quantize` / `kv_dequantize` against the JAX recipe on seeded rows, an
  all-zero row and exact half-way ties (round half to even): q8 equal,
  scales within rtol 1e-6.
- The cache and the paged pool store int8 K/V and f32 scales at the JAX
  shapes.
- `forward_cached` at f32 with an int8 cache against the JAX function
  running its flash kernel in interpret mode (tests/torch_parity.py dims,
  head_dim 256): logits within 1e-5, q8 equal but where the value before
  rounding lies within 1e-4 of a half-integer, there by at most 1; the
  int8 logits within 2 % of the full-precision cache's range.
- The engines under int8 against the JAX engine (on its XLA attention, the
  engine being the subject) on the same weights: greedy tokens equal
  exactly at f32, dense and paged, through staggered admission and slot
  reuse, int8 weights with a registered prefix, eject and resume,
  preemption, `prefill_chunk_tokens`, the prefill role's handoff and a
  weight swap; the int8 paged engine never reaches the paged decode kernel.
- `--int8-kv` and the `int8_kv` `--config` key reach the engine.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.cmd import serve as jserve
from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.ops.quant import quantize_params as jquant
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.utils.config import parse_with_config

import torch_parity as tp

# The engine tests' model: small, MHA, f32, an int8 KV cache.
DIMS = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=128, max_seq=64)
ENGINE = dict(num_slots=2, decode_chunk=3, prefill_len=8)
KINDS = [0, 8]
KIND_IDS = ["dense", "paged"]
PROMPT = [40, 2, 7, 1, 3]
N = 30


@functools.lru_cache(maxsize=None)
def model(int8_weights: bool = False, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) with kv_cache_int8."""
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False,
                                 kv_cache_int8=True)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    if int8_weights:
        jp = jquant(jp)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32,
                                 kv_cache_int8=True)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def port_engine(m=None, *, block_len=0, **kw):
    _, _, cfg, params = m or model()
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu",
                                      kv_block_len=block_len,
                                      **{**ENGINE, **kw})


def jax_engine(m=None, *, block_len=0, **kw):
    jcfg, jp, _, _ = m or model()
    return jsrv.ContinuousBatchEngine(jp, jcfg, kv_block_len=block_len,
                                      **{**ENGINE, **kw})


def jax_generate(prompt, n, m=None):
    jcfg, jp, _, _ = m or model()
    out = jdec.generate(jp, jnp.asarray([prompt], jnp.int32), n, jcfg,
                        max_seq=jcfg.max_seq)
    return np.asarray(out)[0, len(prompt):].tolist()


def uninterrupted(eng, prompt=PROMPT, n=N):
    rid = eng.submit(prompt, n)
    eng.run()
    return eng.result(rid).tokens


def resume_on(eng, st):
    rid = eng.submit(st["prompt"], st["maxNewTokens"],
                     committed=st["committed"] or None,
                     prng_key=st["prngKey"], temperature=st["temperature"],
                     priority=st["priority"], preempted=st["preempted"])
    eng.run()
    return eng.result(rid)


def step_until(eng, cond, limit=200):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    assert cond(), f"condition not reached within {limit} steps"


def pages_all_back(eng):
    kv = eng.metrics()["kv_cache"]
    return kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


@pytest.fixture
def no_paged_kernel(monkeypatch):
    """The paged decode kernel's wrapper, made to fail: an int8 pool must
    never reach it."""
    def refuse(*a, **k):
        raise AssertionError("int8 KV reached the paged decode kernel")
    monkeypatch.setattr(tsrv, "paged_decode_attention", refuse)


# -------------------------------------------------------------- the recipe


def _rows(dtype):
    """Seeded (4, 3, 2, 64) rows, one all zero, and one row of exact
    half-way ties: amax 127 makes the scale exactly 1, so x / scale is x."""
    x = np.random.default_rng(3).normal(0.0, 2.0, (4, 3, 2, 64))
    x[1, 2, 0] = 0.0
    ties = np.arange(64) % 8 - 3.5                 # -3.5 .. 3.5
    ties[0] = 127.0
    x[2, 1, 1] = ties
    return x.astype(np.float32 if dtype == "f32" else np.float64), ties


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_quantize_and_dequantize_match_jax(dtype):
    x, ties = _rows(dtype)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
    jq, js = jdec.kv_quantize(jx)
    tq, ts = tdec.kv_quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert torch.all(tq[1, 2, 0] == 0) and ts[1, 2, 0] > 0
    # Half to even: -3.5 -> -4, -2.5 -> -2, ..., 2.5 -> 2, 3.5 -> 4.
    want = np.round(ties).astype(np.int8)
    np.testing.assert_array_equal(tq[2, 1, 1].numpy(), want)
    jd = jdec.kv_dequantize(jq, js, jdt)
    td = tdec.kv_dequantize(tq, ts, tdt)
    assert td.dtype == tdt
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_storage_is_int8_at_the_jax_shapes(block_len):
    jcfg, _, tcfg, _ = model()
    if block_len:
        want = jdec.init_paged_pool(jcfg, 9, block_len)
        got = tdec.init_paged_pool(tcfg, 9, block_len)
    else:
        want = jdec.init_cache(jcfg, 3)
        got = tdec.init_cache(tcfg, 3)
    assert got.quantized and want.quantized
    for g, w in zip(got.leaves(), (want.k, want.v, want.kscale,
                                   want.vscale)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    plain = tdec.init_cache(dataclasses.replace(tcfg, kv_cache_int8=False), 3)
    assert not plain.quantized and len(plain.leaves()) == 2


# ---------------------------------------------------------- forward_cached


def test_forward_cached_int8_matches_jax_interpret():
    """A 16-token prefill and one decode step at f32 through an int8 cache;
    the JAX function runs its flash kernel in interpret mode. q8 may part
    from JAX's only where the value before rounding is within 1e-4 of a
    half-integer (the two packages' K/V differ in the last bits), and there
    by one step."""
    jcfg, jp, tcfg, params = tp.model()
    jq = dataclasses.replace(jcfg, kv_cache_int8=True)
    tq = dataclasses.replace(tcfg, kv_cache_int8=True)
    prompt = tp.tokens((2, 16), seed=11)
    nxt = tp.tokens((2, 1), seed=12)
    jcache = jdec.init_cache(jq, 2)
    jl0, jcache = jdec.forward_cached(jp, jnp.asarray(prompt), jcache, 0, jq)
    jl1, jcache = jdec.forward_cached(jp, jnp.asarray(nxt), jcache, 16, jq)

    pre = []
    real = tdec.kv_quantize

    def spy(x):
        q8, sc = real(x)
        pre.append((x.float() / sc[..., None]).detach())
        return q8, sc
    tcache = tdec.init_cache(tq, 2)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdec, "kv_quantize", spy)
        tl0, _ = tdec.forward_cached(params, torch.from_numpy(prompt).long(),
                                     tcache, 0, tq)
        tl1, _ = tdec.forward_cached(params, torch.from_numpy(nxt).long(),
                                     tcache, 16, tq)
    for got, want in ((tl0, jl0), (tl1, jl1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    # The pre-round values, laid out as the cache rows: per call (k, v) of
    # one layer at positions [pos, pos + T).
    near = [np.zeros(tcache.k.shape, bool) for _ in "kv"]
    calls = iter(pre)
    for pos, t in ((0, 16), (16, 1)):
        for layer in range(tq.n_layers):
            for which in (0, 1):
                v = next(calls).numpy()
                frac = np.abs(v - np.floor(v) - 0.5)
                near[which][layer, :, pos:pos + t] = frac < 1e-4
    parted = 0
    for got, want, tie in ((tcache.k, jcache.k, near[0]),
                           (tcache.v, jcache.v, near[1])):
        diff = got.numpy().astype(np.int32) - np.asarray(want).astype(
            np.int32)
        assert np.abs(diff).max() <= 1
        assert not np.any(diff[~tie]), "q8 parted away from a tie"
        parted += int(np.count_nonzero(diff))
    assert parted <= sum(int(n.sum()) for n in near)
    np.testing.assert_allclose(tcache.kscale.numpy(),
                               np.asarray(jcache.kscale), rtol=1e-5)
    np.testing.assert_allclose(tcache.vscale.numpy(),
                               np.asarray(jcache.vscale), rtol=1e-5)


def test_int8_logits_close_to_the_full_precision_cache():
    """JAX's quality guard on the port: int8-KV prefill logits within 2 %
    of the full-precision cache's logit range, greedy tokens unchanged."""
    _, _, tcfg, params = model()
    full = dataclasses.replace(tcfg, kv_cache_int8=False)
    prompt = torch.tensor([[3, 17, 29, 5]])
    with torch.no_grad():
        lb, _ = tdec.forward_cached(params, prompt, tdec.init_cache(full, 1),
                                    0, full)
        lq, _ = tdec.forward_cached(params, prompt, tdec.init_cache(tcfg, 1),
                                    0, tcfg)
        base = tdec.generate(params, prompt, 16, full)
        quant = tdec.generate(params, prompt, 16, tcfg)
    err = float((lb - lq).abs().max())
    assert err < 0.02 * float(lb.abs().max())
    assert torch.equal(base, quant), "int8 KV flipped a greedy token"


# ---------------------------------------------------------------- engines


def staggered(eng):
    """test_int8_kv_cache_engine_matches_quantized_generate's arrivals:
    chunked prefill over the quantized temp cache, slot reuse."""
    prompts = [[3, 17, 29, 5], [40, 2, 77],
               [(5 * i + 2) % DIMS["vocab_size"] for i in range(20)]]
    r0 = eng.submit(prompts[0], 12)
    eng.step()
    r1 = eng.submit(prompts[1], 9)
    r2 = eng.submit(prompts[2], 7)
    eng.run()
    return [eng.result(r).tokens for r in (r0, r1, r2)], prompts


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_kv_cache_engine_matches_quantized_generate(block_len,
                                                         no_paged_kernel):
    want, prompts = staggered(jax_engine(block_len=block_len))
    assert want == [jax_generate(p, len(w)) for p, w in zip(prompts, want)]
    eng = port_engine(block_len=block_len)
    assert eng._cache.k.dtype == torch.int8
    assert eng._cache.kscale.dtype == torch.float32
    got, _ = staggered(eng)
    assert got == want
    if block_len:
        assert pages_all_back(eng)


def test_paged_int8_matches_dense_int8(no_paged_kernel):
    prompts = [[3, 17, 29, 5], [40, 2, 7]]
    engines = (port_engine(decode_chunk=4), port_engine(block_len=8,
                                                        decode_chunk=4),
               jax_engine(block_len=8, decode_chunk=4))
    outs = []
    for eng in engines:
        rids = [eng.submit(p, 10) for p in prompts]
        eng.run()
        outs.append([eng.result(r).tokens for r in rids])
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_kv_with_int8_weights_and_prefix(block_len, no_paged_kernel):
    """int8 weights, an int8 KV cache and a registered prefix: the borrowed
    prefix cache is int8, and the tokens are the JAX generate's."""
    m = model(int8_weights=True)
    pfx = [(3 * i + 2) % DIMS["vocab_size"] for i in range(16)]
    suffix = [7, 9, 11]
    want = jax_generate(pfx + suffix, 8, m)
    eng = port_engine(m, block_len=block_len)
    pid = eng.register_prefix(pfx)
    if not block_len:
        temp = eng._prefixes[pid].temp
        assert temp.k.dtype == torch.int8 and temp.quantized
    rid = eng.submit(suffix, 8, prefix_id=pid)
    eng.run()
    assert eng.result(rid).tokens == want
    assert eng.metrics()["prefix_cache"]["hits"] == 1


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_eject_and_resume_match_jax(block_len, no_paged_kernel):
    want = uninterrupted(jax_engine(block_len=block_len))
    src = port_engine(block_len=block_len)
    rid = src.submit(PROMPT, N)
    step_until(src, lambda: len(src.result(rid).tokens) >= 4)
    state = src.eject(rid)
    k = len(state["committed"])
    assert 0 < k < N and state["committed"] == want[:k]
    for dst in (port_engine(block_len=block_len, seed=9, num_slots=3),
                jax_engine(block_len=block_len, seed=9, num_slots=3)):
        assert resume_on(dst, state).tokens == want
    if block_len:
        assert pages_all_back(src)


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_preemption_resumes_to_the_jax_tokens(block_len,
                                                   no_paged_kernel):
    """A decoding batch request preempted for an interactive one on a
    one-slot engine resumes, on the port and on the JAX engine, to the JAX
    engine's uninterrupted tokens; the interactive request's are JAX's
    too."""
    inter = [9, 8, 7, 6]
    want_b = uninterrupted(jax_engine(block_len=block_len))
    want_i = uninterrupted(jax_engine(block_len=block_len), inter, 6)
    eng = port_engine(block_len=block_len, num_slots=1)
    rb = eng.submit(PROMPT, N, priority="batch")
    step_until(eng, lambda: len(eng.result(rb).tokens) >= 3)
    ri = eng.submit(inter, 6)
    eng.run()
    b = eng.result(rb)
    assert b.finish_reason == "migrated"
    st = b.resume_state
    assert st["reason"] == "preempt" and st["preempted"] == 1
    assert eng.result(ri).tokens == want_i
    for dst in (port_engine(block_len=block_len),
                jax_engine(block_len=block_len)):
        assert resume_on(dst, st).tokens == want_b
    if block_len:
        assert pages_all_back(eng)


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_chunked_prefill_bitwise_equal_to_plain(block_len,
                                                     no_paged_kernel):
    """prefill_chunk_tokens 32 under int8: the same tokens and logprobs
    as the plain engine, bit for bit, the JAX engine's tokens, and the JAX
    chunked engine's prefill chunks and decode steps."""
    prompts = [[3, 17, 29, 5], list(range(2, 42)), [40, 2, 77]]

    def run(eng):
        r0 = eng.submit(prompts[0], 12)
        eng.step()
        r1 = eng.submit(prompts[1], 10)
        eng.step()
        r2 = eng.submit(prompts[2], 9)
        eng.run()
        m = eng.metrics()["lifetime"]
        return ([eng.result(r).tokens for r in (r0, r1, r2)],
                [eng.result(r).logprobs for r in (r0, r1, r2)],
                (m["prefill_chunks"], m["decode_steps"]))
    kw = dict(block_len=block_len, decode_chunk=8, prefill_len=32)
    toks, lps, _ = run(port_engine(**kw))
    ctoks, clps, counts = run(port_engine(prefill_chunk_tokens=32, **kw))
    jtoks, _, jcounts = run(jax_engine(prefill_chunk_tokens=32, **kw))
    assert ctoks == toks == jtoks
    assert clps == lps
    assert counts == jcounts


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_handoff_continues_to_the_jax_tokens(block_len,
                                                  no_paged_kernel):
    want = uninterrupted(jax_engine(block_len=block_len))
    pf = port_engine(block_len=block_len, handoff_first_token=True)
    rid = pf.submit(PROMPT, N)
    pf.run()
    st = pf.result(rid).resume_state
    assert st["reason"] == "handoff" and st["committed"] == want[:1]
    for dst in (port_engine(block_len=block_len, seed=5),
                jax_engine(block_len=block_len, seed=5)):
        assert resume_on(dst, st).tokens == want


@pytest.mark.parametrize("block_len", KINDS, ids=KIND_IDS)
def test_int8_swap_params_reprefills_int8_prefixes(block_len,
                                                   no_paged_kernel):
    """A weight swap re-prefills a registered prefix into int8 storage
    under the new weights: a borrower then gets the JAX generate's tokens
    of the new weights."""
    new = model(seed=1)
    pfx = [(7 * i + 1) % DIMS["vocab_size"] for i in range(17)]
    want = jax_generate(pfx + [5, 6], 10, new)
    eng = port_engine(block_len=block_len)
    pid = eng.register_prefix(pfx)
    eng.swap_params(new[3])
    if not block_len:
        assert eng._prefixes[pid].temp.kscale.dtype == torch.float32
    rid = eng.submit([5, 6], 10, prefix_id=pid)
    eng.run()
    assert eng.result(rid).tokens == want


# ------------------------------------------------------------ serve main


@pytest.mark.parametrize("source", ["flag", "config"])
def test_int8_kv_reaches_the_engine(tmp_path, source):
    """--int8-kv and the knob file's serve.int8_kv (the JAX knob) build an
    int8-KV engine; the JAX serve reads both the same way."""
    argv = ["--device", "cpu", "--vocab-size", "64", "--d-model", "32",
            "--n-layers", "1", "--n-heads", "2", "--d-ff", "64",
            "--max-seq", "32", "--prefill-len", "8", "--num-slots", "1"]
    if source == "flag":
        argv.append("--int8-kv")
    else:
        cfg = tmp_path / "ktwe.yaml"
        cfg.write_text("serve:\n  int8_kv: true\n")
        argv += ["--config", str(cfg)]
    args = parse_with_config(serve.build_parser(), "serve", argv)
    assert args.int8_kv is True
    assert serve.DEFAULTS["int8_kv"] is False
    eng = serve.build_engine(args)
    assert eng.cfg.kv_cache_int8 and eng._cache.k.dtype == torch.int8
    off = parse_with_config(serve.build_parser(), "serve", argv[:18])
    assert off.int8_kv is False
    jargs = jserve.build_parser().parse_args(["--int8-kv"])
    assert jargs.int8_kv is True
