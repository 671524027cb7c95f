"""The port's paged KV engine against the JAX package's.

- Host bookkeeping: the port's BlockPool / RadixCache / blocks_needed /
  chain_digest replay one scripted sequence exactly as the JAX package's
  do (the same free lists, chains, evictions and digests).
- `paged_rows`, and the paged decode kernel's plain version against the
  JAX kernel (`paged_decode_attention`, interpret mode) and the JAX
  engine's XLA gather + einsum, at atol 2e-5 in f32 (the same sums taken in
  another order).
- The paged engine against the JAX paged engine on the same weights
  (tests/torch_parity.py: head_dim 256, max_seq 64, f32, block_len 8): greedy
  tokens identical, logprobs within 1e-4, and the pool and radix counters
  equal, in the scenarios of the JAX package's tests/unit/test_paged_kv.py.
- Paged equals dense within the port, and every lease returns (free +
  cached == capacity) after cancels and faults, as
  tests/integration/test_kv_pressure.py pins for the JAX engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.models import kvhost as jkvhost
from k8s_gpu_workload_enhancer_tpu.models import paged_kv as jpkv
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.ops.attention import NEG_INF, repeat_kv
from k8s_gpu_workload_enhancer_tpu.ops.flash_attention import (
    paged_decode_attention as jpaged)
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import paged_kv as tpkv
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
from k8s_gpu_workload_enhancer_tpu_torch.ops import paged_attention as tpa

import torch_parity as tp

BL = 8
KV_FIELDS = ("blocks_total", "blocks_free", "blocks_used", "blocks_shared",
             "blocks_cached", "evictions_total", "deferrals_total",
             "prompt_tokens_total", "matched_tokens_total")


# ---------------------------------------------------------------------------
# Host bookkeeping
# ---------------------------------------------------------------------------


def _bookkeeping_script(m):
    """One scripted sequence of pool / radix operations on module `m`;
    returns everything observable along the way."""
    out = []
    pool = m.BlockPool(num_blocks=12, block_len=4)
    radix = m.RadixCache(pool)
    out.append(("alloc", pool.alloc(3), pool.alloc(20), pool.free_count))
    a_toks = list(range(12))
    b_toks = list(range(50, 58))
    blocks = pool.alloc(3)
    parent = None
    for i, blk in enumerate(blocks):
        parent = radix.insert(parent, a_toks[i * 4:(i + 1) * 4], blk)
    spare = pool.alloc(1)[0]
    dup = radix.insert(None, a_toks[:4], spare)
    out.append(("insert", dup.block, radix.cached_blocks))
    b_blocks = pool.alloc(2)
    node = radix.insert(None, b_toks[:4], b_blocks[0])
    radix.insert(node, b_toks[4:], b_blocks[1])
    chain = radix.match(a_toks + [99])
    out.append(("match", [n.block for n in chain], [n.digest for n in chain],
                len(radix.match(a_toks[:6])), radix.match([7] + a_toks)))
    radix.acquire(chain)
    radix.acquire(chain[:1])
    out.append(("shared", radix.shared_blocks(), radix.evictable_blocks()))
    radix.release(chain)
    radix.pin(radix.match(b_toks))
    out.append(("pinned", radix.pinned_blocks(), radix.evictable_blocks()))
    out.append(("evict", radix.evict(2), radix.evictions_total,
                pool.free_count, [n.block for n in radix.match(a_toks)]))
    radix.release(chain[:1])
    radix.unpin(radix.match(b_toks))
    out.append(("evict-all", radix.evict(10), radix.cached_blocks,
                pool.free_count, list(pool._free)))
    pool.free([spare])
    with pytest.raises(ValueError):
        pool.free([spare])                      # double free
    keep = radix.insert(None, [1, 2, 3, 4], pool.alloc(1)[0])
    radix.acquire([keep])
    radix.detach_all()
    out.append(("detach", radix.match([1, 2, 3, 4]), pool.free_count))
    radix.release([keep])
    out.append(("cow", radix.cow(keep), pool.free_count, list(pool._free)))
    out.append(("needed", [m.blocks_needed(n, 8) for n in (0, 1, 8, 9, 65)]))
    return out


def test_pool_and_radix_replay_the_jax_bookkeeping():
    assert _bookkeeping_script(tpkv) == _bookkeeping_script(jpkv)
    assert tpkv.TRASH_BLOCK == jpkv.TRASH_BLOCK == 0
    for parent, key in (("", [1, 2, 3]), ("ab" * 16, list(range(16))),
                        ("x", [])):
        assert tpkv.chain_digest(parent, key) == jkvhost.chain_digest(parent,
                                                                      key)


def test_paged_rows_matches_jax_including_the_trash_page():
    table = np.asarray([[5, 3, 0, 0]], np.int32)
    pos = np.asarray([[0, 7, 8, 15, 16, 31]], np.int32)
    got = tdec.paged_rows(torch.from_numpy(table), torch.from_numpy(pos), 8)
    want = np.asarray(jdec.paged_rows(jnp.asarray(table), jnp.asarray(pos),
                                      8))
    assert got.tolist() == want.tolist() == [[40, 47, 24, 31, 0, 7]]
    tables = tp.tokens((3, 6), seed=2) % 20
    positions = np.arange(48, dtype=np.int32)[None, :].repeat(3, axis=0)
    got = tdec.paged_rows(torch.from_numpy(tables), torch.from_numpy(positions),
                          8)
    want = jdec.paged_rows(jnp.asarray(tables), jnp.asarray(positions), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Paged decode attention: plain version against both JAX forms
# ---------------------------------------------------------------------------


def _xla_gather(q, kp, vp, table, pos, bl):
    """The JAX engine's gather + einsum decode attention
    (models/serving.py _decode_once_paged, as its test_paged_kv.py builds it)."""
    b, nh, d = q.shape
    nb, _, kh, _ = kp.shape
    s_max = table.shape[1] * bl
    jpos = jax.lax.broadcasted_iota(jnp.int32, (b, s_max), 1)
    rows = jdec.paged_rows(table, jpos, bl)
    kk = repeat_kv(kp.reshape(nb * bl, kh, d)[rows], nh // kh)
    vv = repeat_kv(vp.reshape(nb * bl, kh, d)[rows], nh // kh)
    lg = jnp.einsum("bhd,bkhd->bhk", q, kk,
                    preferred_element_type=jnp.float32) * d ** -0.5
    lg = jnp.where((jpos <= pos[:, None])[:, None, :], lg, NEG_INF)
    return jnp.einsum("bhk,bkhd->bhd", jax.nn.softmax(lg, axis=-1), vv,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("kh,g,d", [(2, 1, 128), (2, 2, 128), (1, 2, 256),
                                    (2, 1, 256)])
def test_paged_decode_plain_matches_jax_kernel_and_gather(kh, g, d):
    b, nb, mb = 4, 13, 4
    rng = np.random.default_rng(d + g)
    kp = rng.standard_normal((nb, BL, kh, d)).astype(np.float32)
    vp = rng.standard_normal((nb, BL, kh, d)).astype(np.float32)
    q = rng.standard_normal((b, kh * g, d)).astype(np.float32)
    # A permuted table (pages in no order, one slot's pages interleaved
    # with another's), a slot at position 0, and a parked slot: an all-
    # trash row at the clamped position max_seq - 1.
    table = np.asarray([[5, 3, 12, 1], [2, 11, 7, 9], [6, 0, 0, 0],
                        [0, 0, 0, 0]], np.int32)
    pos = np.asarray([29, 31, 0, mb * BL - 1], np.int32)
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, table, pos)),
        block_len=BL).numpy()
    jargs = [jnp.asarray(x) for x in (q, kp, vp, table, pos)]
    kernel = np.asarray(jpaged(*jargs, block_len=BL, interpret=True))
    gather = np.asarray(_xla_gather(*jargs, BL))
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, gather, atol=2e-5, rtol=0)


@pytest.mark.parametrize("kh,g,d", [(1, 32, 64), (2, 1, 12), (1, 2, 200),
                                    (2, 1, 1024)])
def test_paged_decode_plain_matches_jax_gather_past_the_kernel_gate(kh, g, d):
    # Shapes the JAX kernel's gate refuses (32 query heads per kv head, head
    # dims that are not multiples of 128 or above 512): the JAX package
    # computes them with the XLA gather, and the CUDA kernel takes them.
    b, nb, mb = 3, 13, 4
    rng = np.random.default_rng(d + g)
    kp = rng.standard_normal((nb, BL, kh, d)).astype(np.float32)
    vp = rng.standard_normal((nb, BL, kh, d)).astype(np.float32)
    q = rng.standard_normal((b, kh * g, d)).astype(np.float32)
    table = np.asarray([[5, 3, 12, 1], [2, 11, 7, 9], [6, 0, 0, 0]],
                       np.int32)
    pos = np.asarray([29, 8, 0], np.int32)
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, table, pos)),
        block_len=BL).numpy()
    gather = np.asarray(_xla_gather(*(jnp.asarray(x) for x in
                                      (q, kp, vp, table, pos)), BL))
    np.testing.assert_allclose(got, gather, atol=2e-5, rtol=0)


def _split_partials(q, kp, vp, table, pos, bl, split):
    """Every split's (acc, (m, l)) of the paged decode function in plain f32
    torch, as the split kernel writes them: splits of `split` positions, an
    empty split (no position at or before pos) m = NEG_INF, l = 0 and an acc
    of NaN, which the combine must never read."""
    b, h, d = q.shape
    nb, _, kh, _ = kp.shape
    span = table.shape[1] * bl
    j = torch.arange(span)
    rows = table.long()[:, j // bl] * bl + j % bl
    kk = kp.reshape(nb * bl, kh, d)[rows].repeat_interleave(h // kh, dim=2)
    vv = vp.reshape(nb * bl, kh, d)[rows].repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q, kk) * d ** -0.5
    n = -(-span // split)
    acc = torch.full((n, b, h, d), float("nan"))
    ml = torch.zeros((n, b, h, 2))
    for i in range(n):
        for slot in range(b):
            lo, hi = i * split, min(span, (i + 1) * split, int(pos[slot]) + 1)
            if hi <= lo:
                ml[i, slot, :, 0] = NEG_INF
                continue
            ss = s[slot, :, lo:hi]
            m = ss.amax(dim=-1).clamp_min(NEG_INF / 2)
            p = torch.exp(ss - m[:, None])
            acc[i, slot] = torch.einsum("hs,shd->hd", p, vv[slot, lo:hi])
            ml[i, slot, :, 0], ml[i, slot, :, 1] = m, p.sum(dim=-1)
    return acc, ml


@pytest.mark.parametrize("split", [8, 16])
def test_paged_decode_combine_plain_merges_split_partials(split):
    # The combine kernel's plain version over the split kernel's partials
    # (some splits empty, their acc NaN) gives the whole function.
    b, kh, g, d, nb, mb = 3, 2, 2, 32, 13, 4
    rng = np.random.default_rng(split)
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, BL, kh, d))
                               .astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, kh * g, d))
                         .astype(np.float32))
    table = torch.tensor([[5, 3, 12, 1], [2, 11, 7, 9], [6, 0, 0, 0]],
                         dtype=torch.int32)
    pos = torch.tensor([29, 8, 0], dtype=torch.int32)
    acc, ml = _split_partials(q, kp, vp, table, pos, BL, split)
    assert torch.isnan(acc).any()
    got = tpa.paged_decode_combine(acc, ml, torch.float32)
    want = tpa.paged_decode_attention_plain(q, kp, vp, table, pos,
                                            block_len=BL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# The paged engine against the JAX paged engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg, jp, tcfg, params = tp.model()
    return jcfg, jp, tcfg, params


def _engines(model, **kw):
    """(JAX paged engine, port paged engine) on the same weights."""
    jcfg, jp, tcfg, params = model
    kw = {"num_slots": 4, "prefill_len": tp.PREFILL_LEN, "decode_chunk": 4,
          "kv_block_len": BL, **kw}
    return (jsrv.ContinuousBatchEngine(jp, jcfg, **kw),
            tsrv.ContinuousBatchEngine(params, tcfg, device="cpu", **kw))


def _reference(model, prompt, n):
    """Isolated greedy continuation (the port's generate)."""
    _, _, cfg, params = model
    out = tdec.generate(params, torch.as_tensor([prompt]), n, cfg)
    return out[0, len(prompt):].tolist()


def _assert_same(jeng, teng, jids, tids):
    for a, b in zip(jids, tids):
        j, t = jeng.result(a), teng.result(b)
        assert t.tokens == j.tokens, f"request {b} diverged from JAX"
        assert t.finish_reason == j.finish_reason
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=1e-4,
                                   rtol=0)
    jm, tm = jeng.metrics(), teng.metrics()
    for f in KV_FIELDS:
        assert tm["kv_cache"][f] == jm["kv_cache"][f], f
    for f in ("hits", "prompt_tokens_saved"):
        assert tm["prefix_cache"][f] == jm["prefix_cache"][f], f
    return tm


def _run_both(jeng, teng, fn):
    return fn(jeng), fn(teng)


def test_single_request_matches_jax_paged_engine(model):
    jeng, teng = _engines(model)
    prompt = [3, 17, 29, 5]
    jids, tids = _run_both(jeng, teng, lambda e: [e.submit(prompt, 12)])
    jeng.run()
    teng.run()
    _assert_same(jeng, teng, jids, tids)
    assert teng.result(tids[0]).tokens == _reference(model, prompt, 12)


def test_staggered_requests_reuse_slots_and_pages_like_jax(model):
    """Six requests through two slots, admitted at different chunk
    boundaries: freed pages go to later requests in another order while
    parked slots decode into the trash page."""
    jeng, teng = _engines(model, num_slots=2, decode_chunk=3)
    prompts = [[40 + i, 2, 7, 1, 3] for i in range(6)]
    lens = [20, 20, 20, 12, 9, 20]

    def drive(e):
        rids = []
        for p, n in zip(prompts, lens):
            rids.append(e.submit(p, n))
            e.step()
        e.run()
        return rids
    jids, tids = _run_both(jeng, teng, drive)
    m = _assert_same(jeng, teng, jids, tids)
    assert m["kv_cache"]["blocks_used"] == m["kv_cache"]["blocks_cached"]


def test_automatic_prefix_reuse_matches_jax_counters(model):
    """Prompts sharing a 40-token prefix (5 full blocks): the first
    publishes its blocks, the others match them, start their suffix
    prefill at offset 32 from rows gathered out of the pool, and commit
    only [40, plen)."""
    jeng, teng = _engines(model, num_slots=3, decode_chunk=3)
    shared = tp.tokens(40, seed=11).tolist()
    prompts = [shared + [30 + i, 9, 8] for i in range(4)]
    jids, tids = _run_both(jeng, teng,
                           lambda e: [e.submit(p, 8) for p in prompts])
    jeng.run()
    teng.run()
    m = _assert_same(jeng, teng, jids, tids)
    assert m["prefix_cache"]["hits"] == 3
    assert m["kv_cache"]["matched_tokens_total"] == 3 * 40
    assert m["kv_cache"]["blocks_cached"] == 5
    assert m["kv_cache"]["blocks_used"] == m["kv_cache"]["blocks_cached"]
    for rid, p in zip(tids, prompts):
        assert teng.result(rid).tokens == _reference(model, p, 8)


def test_pool_exhaustion_defers_and_completes_like_jax(model):
    jeng, teng = _engines(model, kv_num_blocks=9)       # 8 usable pages
    prompts = [[40 + i, 2, 7, 1, 3] for i in range(5)]  # 4 pages each
    jids, tids = _run_both(jeng, teng,
                           lambda e: [e.submit(p, 20) for p in prompts])
    jeng.run()
    teng.run()
    m = _assert_same(jeng, teng, jids, tids)
    assert m["kv_cache"]["deferrals_total"] > 0
    assert m["kv_cache"]["blocks_free"] == (m["kv_cache"]["blocks_total"]
                                            - m["kv_cache"]["blocks_cached"])


def test_unsatisfiable_reservation_fails_like_jax(model):
    """Six of eight pages pinned: a request needing four fails with a cause
    instead of deferring at the queue head forever, and the request behind
    it is served."""
    jeng, teng = _engines(model, num_slots=2, kv_num_blocks=9)
    warm = list(range(1, 49))

    def drive(e):
        w = e.submit(warm, 2)
        e.run()
        e._radix.pin(e._radix.match(warm))              # 6 blocks pinned
        rids = [w, e.submit([5, 6, 7, 8, 9], 20), e.submit([3, 2], 8)]
        e.run()
        return rids
    jids, tids = _run_both(jeng, teng, drive)
    _assert_same(jeng, teng, jids, tids)
    doomed = teng.result(tids[1])
    assert doomed.finish_reason == "error" and "reclaimable" in doomed.error
    assert teng.result(tids[2]).tokens == _reference(model, [3, 2], 8)


def test_oversized_request_refused_at_submit_like_jax(model):
    jeng, teng = _engines(model, kv_num_blocks=4)       # 3 usable pages
    for e in (jeng, teng):
        with pytest.raises(ValueError, match="KV blocks"):
            e.submit([1, 2, 3], 30)                     # needs 5 pages
        e.submit([1, 2, 3], 20)                         # 3 pages: taken


# ---------------------------------------------------------------------------
# Within the port: paged == dense, and every lease returns
# ---------------------------------------------------------------------------


def _port_engine(model, **kw):
    _, _, cfg, params = model
    kw = {"num_slots": 2, "prefill_len": tp.PREFILL_LEN, "decode_chunk": 4,
          **kw}
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu", **kw)


def _no_leaks(eng):
    m = eng.metrics()["kv_cache"]
    assert eng._leases == {}
    assert m["blocks_used"] == m["blocks_cached"]
    assert m["blocks_free"] + m["blocks_cached"] == m["blocks_total"]


def test_paged_equals_dense_within_the_port(model):
    prompts = [tp.tokens(45, seed=4).tolist(), [3, 17, 29, 5],
               tp.tokens(45, seed=4).tolist()[:41] + [7, 7], [40, 2, 77]]
    lens = [12, 10, 9, 14]

    def drive(e):
        rids = []
        for p, n in zip(prompts, lens):
            rids.append(e.submit(p, n))
            e.step()
        e.run()
        return [e.result(r).tokens for r in rids]
    kernels.reset_launches()
    paged = _port_engine(model, kv_block_len=BL)
    assert drive(paged) == drive(_port_engine(model))
    assert paged.metrics()["kv_cache"]["matched_tokens_total"] == 40
    assert sum(kernels.launches.values()) == 0       # CPU: plain versions
    _no_leaks(paged)


def test_cancel_queued_prefilling_and_decoding_returns_every_page(model):
    eng = _port_engine(model, kv_block_len=BL, prefill_interleave=1)
    capacity = eng._pool.capacity
    decoy = eng.submit([9, 9], 40)           # keeps a slot decoding, so
    eng.step()                               # prefill runs a chunk a step
    baseline = eng._pool.free_count
    queued = eng.submit([5, 5, 5], 10)
    long_prompt = tp.tokens(45, seed=6).tolist()
    mid = eng.submit(long_prompt, 10)
    eng.cancel(queued)                       # queued: holds no lease
    eng.step()                               # mid: 1 of 2 prefill chunks
    assert eng._prefill is not None and eng._prefill.req.req_id == mid
    assert eng._pool.free_count < baseline
    eng.cancel(mid)
    assert eng._pool.free_count == baseline
    eng.cancel(decoy)                        # decoding
    assert eng._pool.free_count == capacity and eng._leases == {}
    assert not eng._table_d.any()            # every slot parked
    fresh = eng.submit(long_prompt, 10)
    eng.run()
    assert eng.result(fresh).tokens == _reference(model, long_prompt, 10)
    _no_leaks(eng)


def test_prefill_fault_returns_the_lease(model, monkeypatch):
    eng = _port_engine(model, kv_block_len=BL)
    baseline = eng._pool.free_count

    def boom(*a, **kw):
        raise RuntimeError("injected prefill fault")
    monkeypatch.setattr(tsrv, "_prefill_final_paged", boom)
    rid = eng.submit(tp.tokens(45, seed=7).tolist(), 8)
    eng.run()
    monkeypatch.undo()
    r = eng.result(rid)
    assert r.finish_reason == "error" and "prefill" in r.error
    assert eng._errors_total["prefill"] == 1
    assert eng._leases == {} and eng._pool.free_count == baseline
    ok = eng.submit([3, 17, 29, 5], 8)
    eng.run()
    assert eng.result(ok).tokens == _reference(model, [3, 17, 29, 5], 8)
    _no_leaks(eng)


def test_decode_fault_returns_leases_and_spares_the_prefill(model,
                                                             monkeypatch):
    """A decode fault fails the decoding slots and returns their pages; a
    request mid-prefill was not touched by it, keeps its lease (including
    its radix-matched pages) and completes exactly. prefill_len 8, so the
    request is still prefilling after the step the fault hits."""
    eng = _port_engine(model, kv_block_len=BL, prefill_len=8,
                       prefill_interleave=1)
    shared = tp.tokens(16, seed=8).tolist()
    warm = eng.submit(shared + [70], 2)
    eng.run()
    decoy = eng.submit([9, 9], 40)
    eng.step()
    victim_prompt = shared + tp.tokens(21, seed=9).tolist()   # 37 tokens
    victim = eng.submit(victim_prompt, 4)
    eng.step()                         # 2 blocks hit; chunk 1 of 3 (16..23)
    assert eng._prefill is not None and eng._prefill.req.req_id == victim
    calls = {"n": 0}
    orig = tsrv._decode_chunk_paged

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected decode fault")
        return orig(*a, **kw)
    monkeypatch.setattr(tsrv, "_decode_chunk_paged", boom)
    eng.step()
    monkeypatch.undo()
    assert eng.result(decoy).finish_reason == "error"
    assert eng._errors_total["dispatch"] == 1
    eng.run()
    assert eng.result(warm).done
    got = eng.result(victim)
    assert got.finish_reason == "length"
    assert got.tokens == _reference(model, victim_prompt, 4)
    assert eng.metrics()["kv_cache"]["matched_tokens_total"] == 16
    _no_leaks(eng)
