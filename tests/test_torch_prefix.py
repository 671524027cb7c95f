"""Registered prefixes on the port's engine against the JAX package's.

- `register_prefix` then `submit(prefix_id=)` on the dense and the paged
  engine, with a prefix longer than prefill_len (dense: a borrowed grid)
  and one shorter (dense: no cache; paged: its full blocks): the same
  greedy tokens, logprobs within 1e-4, `prefix_cached_len` and prefix /
  pool counters as the JAX engine on the same weights
  (tests/torch_parity.py dims), and the same tokens as the full prompt
  without a prefix. Two borrowers in a row equal cold, and the dense
  prefix's cache is the same after them (a borrower prefills a copy).
- `release_prefix` returns the pinned pages; a full registry and an
  exhausted pool raise QueueFull (retryable or not) as in JAX.
- `swap_params` with registered prefixes (JAX
  tests/unit/test_serving.py and test_paged_kv.py swap pins): after the
  swap a prefix request equals the full prompt on the new weights (the JAX
  `decode.generate` tokens); a fault while re-prefilling leaves the old
  weights, the old prefixes and no leaked page.
"""

import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv

import torch_parity as tp

BL = 8
# Prefixes: 40 tokens (one 32-token prefill chunk cached dense, 5 blocks
# paged) and 20 (no dense cache, 2 blocks paged); 8- and 5-token suffixes.
LONG, SHORT = tp.tokens(40, seed=11).tolist(), tp.tokens(20, seed=12).tolist()
SUFFIXES = [tp.tokens(8, seed=13).tolist(), tp.tokens(5, seed=14).tolist()]
NEW = 10
KV_FIELDS = ("blocks_free", "blocks_used", "blocks_shared", "blocks_cached",
             "prompt_tokens_total", "matched_tokens_total")


@pytest.fixture(scope="module")
def model():
    return tp.model()


def _kw(paged):
    kw = {"num_slots": 2, "prefill_len": tp.PREFILL_LEN, "decode_chunk": 4}
    if paged:
        kw["kv_block_len"] = BL
    return kw


def port_engine(params, cfg, paged, **kw):
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu",
                                      **_kw(paged), **kw)


def _borrow_twice(eng, prefix):
    """Register `prefix`, then two borrowers one after the other."""
    pid = eng.register_prefix(prefix)
    out = []
    for suffix in SUFFIXES:
        rid = eng.submit(suffix, NEW, prefix_id=pid)
        eng.run()
        out.append(eng.result(rid))
    return pid, out


def _cold(params, cfg, prompt):
    out = tdec.generate(params, torch.as_tensor([prompt]), NEW, cfg)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("prefix", [LONG, SHORT], ids=["long", "short"])
def test_prefix_matches_jax_engine_and_the_full_prompt(model, paged, prefix):
    jcfg, jp, cfg, params = model
    jeng = jsrv.ContinuousBatchEngine(jp, jcfg, **_kw(paged))
    teng = port_engine(params, cfg, paged)
    used0 = teng.metrics()["kv_cache"]["blocks_used"]
    jpid, jout = _borrow_twice(jeng, prefix)
    tpid, tout = _borrow_twice(teng, prefix)
    assert teng.prefix_cached_len(tpid) == jeng.prefix_cached_len(jpid)
    want_cached = ((len(prefix) // BL) * BL if paged
                   else (len(prefix) // tp.PREFILL_LEN) * tp.PREFILL_LEN)
    assert teng.prefix_cached_len(tpid) == want_cached
    for j, t, suffix in zip(jout, tout, SUFFIXES):
        assert t.tokens == j.tokens and t.finish_reason == "length"
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4,
                                   rtol=0)
        assert t.tokens == _cold(params, cfg, prefix + suffix)
    jm, tm = jeng.metrics(), teng.metrics()
    assert tm["prefix_cache"] == jm["prefix_cache"]
    assert tm["prefix_cache"]["registered"] == 1
    for f in KV_FIELDS:
        assert tm["kv_cache"][f] == jm["kv_cache"][f], f
    if not paged:
        pfx, grid = teng._prefixes[tpid], teng.prefix_cached_len(tpid)
        if grid == 0:
            assert pfx.temp is None
        else:
            # The borrowers prefilled copies: the prefix's cache is still
            # the registered grid's, bit for bit.
            fresh = teng._prefill_grid(prefix, grid)
            assert torch.equal(pfx.temp.k, fresh.k)
            assert torch.equal(pfx.temp.v, fresh.v)
    teng.release_prefix(tpid)
    jeng.release_prefix(jpid)
    assert teng.metrics()["prefix_cache"]["registered"] == 0
    if paged:
        # Unpinned, the chain stays cached until pressure evicts it.
        kv = teng.metrics()["kv_cache"]
        assert kv["blocks_used"] == kv["blocks_cached"]
        assert teng._radix.pinned_blocks() == 0
        teng._radix.evict(kv["blocks_cached"])
        assert teng.metrics()["kv_cache"]["blocks_used"] == used0
    with pytest.raises(KeyError):
        teng.release_prefix(tpid)
    with pytest.raises(ValueError, match="unknown prefix"):
        teng.submit(SUFFIXES[0], NEW, prefix_id=tpid)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_registry_full_and_pool_exhausted_like_jax(model, paged):
    """max_prefixes 2: a third registration is QueueFull(retryable=False);
    paged with 5 pages: a 4-block prefix beside a pinned 2-block one is
    QueueFull(retryable=True), and a 2-block one fits."""
    jcfg, jp, cfg, params = model
    kw = dict(max_prefixes=2, kv_num_blocks=6 if paged else 0)

    def script(eng, queue_full):
        out = [eng.register_prefix(LONG[:17])]
        if paged:
            with pytest.raises(queue_full) as e:
                eng.register_prefix(SHORT[:8] + LONG[:24])
            out.append(("pool", e.value.retryable))
        out.append(eng.register_prefix(SHORT))
        with pytest.raises(queue_full) as e:
            eng.register_prefix([1, 2, 3])
        out.append(("full", e.value.retryable))
        with pytest.raises(ValueError):
            eng.register_prefix(list(range(63)))      # > max_seq - 2
        out.append([eng.prefix_cached_len(p) for p in (0, 1)])
        return out
    want = script(jsrv.ContinuousBatchEngine(jp, jcfg, **_kw(paged), **kw),
                  jsrv.QueueFull)
    got = script(port_engine(params, cfg, paged, **kw), tsrv.QueueFull)
    assert got == want
    assert ("full", False) in got and (not paged or ("pool", True) in got)


def _jax_generate(jcfg, jparams, prompt):
    import jax.numpy as jnp
    from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
    out = jdec.generate(jparams, jnp.asarray([prompt], jnp.int32), NEW,
                        jcfg, max_seq=jcfg.max_seq)
    return np.asarray(out)[0, len(prompt):].tolist()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_re_prefills_registered_prefixes(model, paged):
    jcfg, _, cfg, ta = model
    _, jb, _, tb = tp.model(seed=42)
    eng = port_engine(ta, cfg, paged)
    pids = [eng.register_prefix(LONG), eng.register_prefix(SHORT)]
    eng.swap_params(tb)
    assert [eng.prefix_cached_len(p) for p in pids] == (
        [40, 16] if paged else [32, 0])
    for pid, prefix in zip(pids, (LONG, SHORT)):
        rid = eng.submit(SUFFIXES[0], NEW, prefix_id=pid)
        eng.run()
        want = _jax_generate(jcfg, jb, prefix + SUFFIXES[0])
        assert eng.result(rid).tokens == want
        assert want == _cold(tb, cfg, prefix + SUFFIXES[0])
    if paged:
        assert eng._radix.pinned_blocks() == 5 + 2
        for pid in pids:
            eng.release_prefix(pid)
        kv = eng.metrics()["kv_cache"]
        assert kv["blocks_used"] == kv["blocks_cached"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_staging_fault_keeps_old_weights_and_prefixes(model, paged,
                                                           monkeypatch):
    """Two prefixes of 40 and 33 tokens (dense: one grid chunk each; paged:
    5 and 4 blocks, three staging chunks); the last re-prefill chunk
    raises: the first prefix's staged pages go back, and the engine keeps
    the old weights and the old prefixes."""
    jcfg, ja, cfg, ta = model
    _, _, _, tb = tp.model(seed=42)
    second = SHORT + SHORT[:13]
    # Paged: 31 pages, room for the 9 pinned and the 9 staged.
    eng = port_engine(ta, cfg, paged, kv_num_blocks=32 if paged else 0)
    pids = [eng.register_prefix(LONG), eng.register_prefix(second)]
    chains = {p: list(eng._prefixes[p].chain or []) for p in pids}
    temps = {p: eng._prefixes[p].temp for p in pids}
    free0 = eng._pool.free_count if paged else None
    calls = {"n": 0}
    real = tsrv._prefill_step

    def faulty(*a, **kw):
        calls["n"] += 1
        if calls["n"] == (3 if paged else 2):
            raise RuntimeError("injected staging fault")
        return real(*a, **kw)
    monkeypatch.setattr(tsrv, "_prefill_step", faulty)
    with pytest.raises(RuntimeError, match="injected"):
        eng.swap_params(tb)
    monkeypatch.setattr(tsrv, "_prefill_step", real)
    assert eng.params is ta
    assert eng.metrics()["resilience"]["weight_swaps"] == 0
    for p in pids:
        assert eng._prefixes[p].temp is temps[p]
        assert list(eng._prefixes[p].chain or []) == chains[p]
    if paged:
        assert eng._pool.free_count == free0
        assert eng._radix.pinned_blocks() == 5 + 4
    for pid, prefix in zip(pids, (LONG, second)):
        rid = eng.submit(SUFFIXES[1], NEW, prefix_id=pid)
        eng.run()
        assert eng.result(rid).tokens == _jax_generate(
            jcfg, ja, prefix + SUFFIXES[1])
