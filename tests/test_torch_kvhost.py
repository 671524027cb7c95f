"""The port's host KV tier and prefix-warmth gossip against the JAX
package's (models/kvhost.py and the paged engine's hooks).

- Primitives: `prompt_digests`, `PrefixBloom` (hex, `match_depth`, the
  malformed-payload errors) equal the JAX module's; `mesh_signature` names
  the backend ("backend=torch" where JAX has "").
- Both engines, the same traffic: the paged engine with `kv_host_blocks`
  under eviction (explicit, and by admission in a short pool), with the
  demote-ahead watermark, with int8 KV and with a tier smaller than the
  eviction stream. Tokens, the `kvhost` block (bloom included, less
  `dma_seconds_total`), the radix tree (digest, page, references, pins a
  node), leases and free pages equal the JAX engine's after every phase,
  and every restored page equals the page that was demoted, bit for bit.
  Without a tier the bloom equals the JAX paged engine's; a dense engine
  sends an empty one.
- `/v1/kvhost`'s halves: a torch export imported into another torch
  engine is a prefetch hit; the JAX tier refuses a torch payload and the
  torch tier a JAX one (the signatures differ; the payload format is the
  same); a corrupt, malformed or foreign-layout payload is refused.
- FaultLab: a `TargetedPlan` at each `kvhost.*` site, and a seeded plan
  over all three through a chaos cycle (the JAX
  `test_host_tier_chaos_cycle_zero_wrong_tokens` traffic), give the JAX
  engine's outcomes at the same occurrences.
- The flight recorder's `prefetch` span splits queue_wait and prefill as
  the JAX recorder does.
- The fleet: the JAX `ReplicaRegistry` reads a torch replica's
  `/v1/metrics` bloom, and the JAX `FleetRouter` (`bloom_match_pick`)
  sends a prompt to the torch replica that holds its prefix.
- The serve main: the three flags with the JAX knob defaults, their
  `serve:` keys, the parser error against the JAX main's, and `/v1/kvhost`
  over HTTP with its 400.
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu import faultlab as jfl
from k8s_gpu_workload_enhancer_tpu.autopilot import knobs as jknobs
from k8s_gpu_workload_enhancer_tpu.cmd import serve as jserve
from k8s_gpu_workload_enhancer_tpu.fleet.registry import (ReplicaRegistry,
                                                          ReplicaState)
from k8s_gpu_workload_enhancer_tpu.fleet.router import (FleetRouter,
                                                        bloom_match_pick)
from k8s_gpu_workload_enhancer_tpu.models import kvhost as jkv
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.observability import flight as jflight
from k8s_gpu_workload_enhancer_tpu.utils import tracing as jtr
from k8s_gpu_workload_enhancer_tpu_torch import faultlab as tfl
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import kvhost as tkv
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.observability import \
    flight as tflight
from k8s_gpu_workload_enhancer_tpu_torch.utils import tracing as ttr
from k8s_gpu_workload_enhancer_tpu_torch.utils.config import parse_with_config

import torch_parity  # noqa: F401  (one intra-op thread a process)
from test_torch_flight import OFF, PERF, WALL, _record
from test_torch_serve_fleet import ARGS, Replica, _run_main, call

DIMS = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=128, max_seq=64)
BL = 8
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=4, kv_block_len=BL)
# 27 tokens: 3 full blocks, 3 left over, so the prefetch walk restores
# every full block and leaves >= 1 prompt token for the first token.
PROMPT = list(range(1, 28))
# Three prompts of other prefixes (2 full blocks each); in a pool of 8
# pages each admission of one evicts PROMPT's cold pages.
OTHERS = [[40 + i, 41 + i] + list(range(60 + 9 * i, 79 + 9 * i))
          for i in range(3)]
# PROMPT's first two blocks under another tail: a partial re-arrival.
TAIL = PROMPT[:16] + [99, 98, 97, 96, 95]
KVHOST_SITES = ("kvhost.dma", "kvhost.fetch", "kvhost.corrupt")


def cfgs(int8=False):
    return (jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                  use_ring_attention=False,
                                  kv_cache_int8=int8),
            ttf.TransformerConfig(**DIMS, dtype=torch.float32,
                                  kv_cache_int8=int8))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = cfgs()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")


def engines(model, int8=False, **kw):
    jp, tp = model
    jcfg, tcfg = cfgs(int8)
    kw = {**ENGINE, **kw}
    return (jsrv.ContinuousBatchEngine(jp, jcfg, **kw),
            tsrv.ContinuousBatchEngine(tp, tcfg, device="cpu", **kw))


@pytest.fixture(autouse=True)
def inert():
    for fl in (jfl, tfl):
        fl.activate(fl.FaultPlan(0, rate=0.0))
        fl.deactivate()
    yield
    jfl.deactivate()
    tfl.deactivate()


def evict_all(eng):
    eng._radix.evict(eng.metrics()["kv_cache"]["blocks_cached"])


def state(eng) -> dict:
    """What must equal the JAX engine's: the kvhost block less its wall
    clock, the radix tree node by node, the leases and the pool."""
    kv = dict(eng.metrics()["kvhost"])
    kv.pop("dma_seconds_total")
    nodes, stack = [], list(eng._radix.root.children.values())
    while stack:
        n = stack.pop()
        nodes.append((n.digest, n.block, n.ref, n.pins))
        stack.extend(n.children.values())
    return dict(kvhost=kv, nodes=sorted(nodes),
                leases=sorted(eng._leases), free=eng._pool.free_count,
                lifetime=eng.metrics()["lifetime"])


def watch_demotions(eng) -> dict:
    """digest -> the page's leaves as they were when it was demoted."""
    seen = {}
    real = eng._radix.on_evict

    def hook(node):
        seen[node.digest] = [t[:, node.block].clone()
                             for t in eng._cache.leaves()]
        real(node)
    eng._radix.on_evict = hook
    return seen


def restored_pages_equal(eng, demoted: dict) -> int:
    """Every tree page whose block was demoted holds it bit for bit; returns
    how many were checked."""
    n, stack = 0, list(eng._radix.root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        if node.digest in demoted:
            for got, want in zip(eng._cache.leaves(), demoted[node.digest]):
                assert torch.equal(got[:, node.block], want), node.digest
            n += 1
    return n


def run_one(eng, prompt, n=8):
    rid = eng.submit(prompt, n)
    eng.run()
    r = eng.result(rid)
    return (r.tokens, r.finish_reason)


def traffic(eng) -> list:
    """The phases both engines run, each phase's result and state."""
    out = []
    out.append((run_one(eng, PROMPT), state(eng)))
    evict_all(eng)
    out.append((None, state(eng)))
    out.append((run_one(eng, PROMPT), state(eng)))
    for p in OTHERS:
        out.append((run_one(eng, p, 10), state(eng)))
    out.append((run_one(eng, PROMPT), state(eng)))
    out.append((run_one(eng, TAIL, 6), state(eng)))
    return out


# ---------------------------------------------------------------- primitives

def test_digests_bloom_and_signature_equal_jax():
    toks = list(range(100))
    for bl, limit in ((8, 32), (4, 5), (0, 32), (7, 2)):
        assert tkv.prompt_digests(toks, bl, limit) == \
            jkv.prompt_digests(toks, bl, limit)
    ds = tkv.prompt_digests(toks, 8)
    tb, jb = tkv.PrefixBloom(), jkv.PrefixBloom()
    for d in ds[:5] + ["x", "y"]:
        tb.add(d)
        jb.add(d)
    assert tb.to_hex() == jb.to_hex()
    for bits, hashes in ((1024, 3), (64, 7)):
        t2, j2 = tkv.PrefixBloom(bits, hashes), jkv.PrefixBloom(bits, hashes)
        for d in ds:
            t2.add(d)
            j2.add(d)
        assert t2.to_hex() == j2.to_hex()
    wire = tkv.PrefixBloom.from_hex(jb.to_hex(), jb.bits, jb.hashes)
    assert wire.match_depth(ds) == jb.match_depth(ds) == 5
    orphan = tkv.PrefixBloom()
    orphan.add(ds[2])
    assert orphan.match_depth(ds) == 0
    for bad in (lambda m: m.PrefixBloom(bits=12),
                lambda m: m.PrefixBloom(bits=0),
                lambda m: m.PrefixBloom(hashes=0),
                lambda m: m.PrefixBloom.from_hex(jb.to_hex(), 8192, 4),
                lambda m: m.PrefixBloom.from_hex("zz", 8, 4)):
        with pytest.raises(ValueError) as te:
            bad(tkv)
        with pytest.raises(ValueError) as je:
            bad(jkv)
        assert str(te.value) == str(je.value)
    # The signature names the backend: a JAX page is a miss here.
    assert jkv.mesh_signature(None, "tp") == ""
    assert tkv.mesh_signature(None, "tp") == "backend=torch"
    mesh = type("M", (), {"shape": {"tp": 2, "dp": 1}})()
    assert tkv.mesh_signature(mesh, "tp") == \
        "backend=torch|" + jkv.mesh_signature(mesh, "tp")
    assert tkv.HostBlockTier(capacity=1, block_len=8).mesh_sig == \
        "backend=torch"
    for m in (tkv, jkv):
        with pytest.raises(ValueError, match="must be >= 1"):
            m.HostBlockTier(capacity=0, block_len=8)


# ------------------------------------------------------- the two engines

@pytest.mark.parametrize("variant", ["plain", "watermark", "int8",
                                     "small_tier"])
def test_engines_equal_jax_and_restore_bit_for_bit(model, variant):
    kw = dict(kv_num_blocks=9, kv_host_blocks=16)
    if variant == "watermark":
        kw["kv_offload_watermark"] = 0.5
    if variant == "small_tier":
        kw["kv_host_blocks"] = 2
    je, te = engines(model, int8=variant == "int8", **kw)
    demoted = watch_demotions(te)
    ptrs = [t.data_ptr() for t in te._cache.leaves()]
    got, want = traffic(te), traffic(je)
    # Restores write the pool in place: the tensors keep their storage.
    assert [t.data_ptr() for t in te._cache.leaves()] == ptrs
    for i, ((g_out, g_state), (w_out, w_state)) in enumerate(zip(got,
                                                                 want)):
        assert g_out == w_out, (variant, i)
        assert g_state == w_state, (variant, i)
    tier = te._host_tier
    assert tier.offloads_total >= 3 and tier.hits_total >= 2
    if variant == "small_tier":
        assert tier.blocks_used == 2 and tier.discards_total >= 1
    else:
        assert tier.prefetches_total >= 5
        assert restored_pages_equal(te, demoted) >= 3
    assert te.metrics()["kvhost"]["dma_seconds_total"] > 0.0
    if variant == "watermark":
        assert te._radix.evictions_total > 0
    kv = te.metrics()["kv_cache"]
    assert kv["blocks_used"] == kv["blocks_cached"]
    assert all(r.finish_reason == "length" for r in te._reqs.values())


def test_bloom_without_a_tier_equals_jax_and_dense_is_empty(model):
    je, te = engines(model, kv_gossip_interval=0.5)
    for eng in (je, te):
        run_one(eng, PROMPT)
        run_one(eng, OTHERS[0])
    jm, tm = je.metrics()["kvhost"], te.metrics()["kvhost"]
    assert tm == jm and tm["bloom"] and not tm["enabled"]
    assert tm["block_len"] == BL and tm["capacity"] == 0
    bloom = tkv.PrefixBloom.from_hex(tm["bloom"], tm["bloom_bits"],
                                     tm["bloom_hashes"])
    assert bloom.match_depth(tkv.prompt_digests(PROMPT, BL)) == 3
    # Rebuilt at most every kv_gossip_interval seconds.
    run_one(te, OTHERS[1])
    assert te.metrics()["kvhost"]["bloom"] == tm["bloom"]
    te._kv_bloom_at -= 1.0
    assert te.metrics()["kvhost"]["bloom"] != tm["bloom"]
    jd, td = engines(model, kv_block_len=0, kv_host_blocks=4)
    for eng in (jd, td):
        run_one(eng, PROMPT)
    assert td.metrics()["kvhost"] == jd.metrics()["kvhost"]
    assert td.metrics()["kvhost"]["bloom"] == "" and td._host_tier is None
    # A stub snapshot without the block reads as tier-off, as on JAX.
    stubs = [{k: v for k, v in e.metrics_snapshot().items() if k != "kvhost"}
             for e in (td, jd)]
    assert tsrv.ContinuousBatchEngine.aggregate_metrics(stubs[0])[
        "kvhost"] == jsrv.ContinuousBatchEngine.aggregate_metrics(stubs[1])[
        "kvhost"]


def test_swap_clears_the_tier(model):
    """A weight swap discards the tier's blocks (their KV is the old
    weights'): the next request re-prefills under the new weights."""
    _, te = engines(model, kv_host_blocks=16)
    run_one(te, PROMPT)
    evict_all(te)
    assert te._host_tier.blocks_used == 3
    jp2 = jtf.init_params(jax.random.PRNGKey(1), cfgs()[0])
    tp2 = ttf.params_from_numpy(jax.tree.map(np.asarray, jp2), cfgs()[1],
                                "cpu")
    te.swap_params(tp2)
    assert te._host_tier.blocks_used == 0
    assert te._host_tier.discards_total == 3
    fresh = tsrv.ContinuousBatchEngine(tp2, cfgs()[1], device="cpu",
                                       **ENGINE)
    assert run_one(te, PROMPT) == run_one(fresh, PROMPT)
    assert te._host_tier.prefetches_total == 0


# ------------------------------------------------------- export / import

def test_export_import_ships_warmth_and_refuses_foreign_pages(model):
    je, te = engines(model, kv_host_blocks=16)
    _, peer = engines(model, kv_host_blocks=16)
    want = run_one(te, PROMPT)
    assert run_one(je, PROMPT) == want
    evict_all(te)
    evict_all(je)
    digests = tkv.prompt_digests(PROMPT, BL)
    payloads = json.loads(json.dumps(te.kvhost_export(digests + ["nope"])))
    assert len(payloads) == 3 and te._host_tier.exports_total == 3
    jpay = json.loads(json.dumps(je.kvhost_export(digests)))
    # The same keys and array specs in both packages.
    for t, j in zip(payloads, jpay):
        assert set(t) == set(j)
        assert t["digest"] == j["digest"] and t["key"] == j["key"]
        assert {n: (a["dtype"], a["shape"]) for n, a in t["arrays"].items()} \
            == {n: (a["dtype"], a["shape"]) for n, a in j["arrays"].items()}
        assert (t["mesh_sig"], j["mesh_sig"]) == ("backend=torch", "")
    # Signatures differ: each tier refuses the other package's pages.
    assert peer.kvhost_import(jpay) == 0
    assert je.kvhost_import(payloads) == 0
    # The format is the same: aligned signatures, a JAX payload's crc
    # checks in the torch tier.
    aligned = tkv.HostBlockTier(capacity=4, block_len=BL)
    aligned.mesh_sig = ""
    assert aligned.import_entry(jpay[0])
    tampered = dict(payloads[0], crc=payloads[0]["crc"] ^ 1)
    assert peer.kvhost_import([tampered]) == 0
    assert peer._host_tier.corrupt_drops_total == 1
    assert peer.kvhost_import([{"digest": "d"}]) == 0
    wrong = json.loads(json.dumps(payloads[0]))
    wrong["arrays"]["k"]["shape"] = [1, -1]
    assert peer.kvhost_import([wrong]) == 0
    bad_b64 = json.loads(json.dumps(payloads[0]))
    bad_b64["arrays"]["k"]["b64"] = "!!"
    assert peer.kvhost_import([bad_b64]) == 0
    assert peer._host_tier.blocks_used == 0
    assert peer.kvhost_import(payloads) == 3
    assert peer._host_tier.imports_total == 3
    assert run_one(peer, PROMPT) == want
    assert peer._host_tier.prefetches_total == 3
    assert peer._host_tier.hits_total == 3
    # A dense engine (no tier) ships nothing and takes nothing.
    dense = tsrv.ContinuousBatchEngine(model[1], cfgs()[1], device="cpu",
                                       num_slots=2, prefill_len=8,
                                       decode_chunk=4)
    assert dense.kvhost_export(digests) == [] and \
        dense.kvhost_import(payloads) == 0


def test_cross_signature_and_rotten_entries_are_misses(model):
    _, te = engines(model, kv_host_blocks=16)
    want = run_one(te, PROMPT)
    evict_all(te)
    tier = te._host_tier
    d0, d1 = tkv.prompt_digests(PROMPT, BL)[:2]
    tier._entries[d0].mesh_sig = ""
    assert tier.fetch(d0) is None and tier.hits_total == 0
    tier._entries[d0].mesh_sig = tier.mesh_sig
    entry = tier._entries[d1]
    tier._finalize_entry(entry)
    entry.arrays["k"] = entry.arrays["k"].clone()
    entry.arrays["k"].view(-1)[0] += 1.0
    assert tier.fetch(d1) is None
    assert tier.corrupt_drops_total == 1 and d1 not in tier
    assert run_one(te, PROMPT) == want
    assert tier.prefetches_total == 1          # d0 only; d1 re-prefilled


# ------------------------------------------------------------- FaultLab

@pytest.mark.parametrize("site", KVHOST_SITES)
def test_targeted_faults_end_as_the_jax_engine_does(model, site):
    """One fault at the first crossing of each kvhost site: the JAX
    engine's counters and tokens, every request ending as a plain
    re-prefill with the unfaulted tokens."""
    outs = []
    for fl, eng in zip((jfl, tfl), engines(model, kv_host_blocks=16)):
        want = run_one(eng, PROMPT)
        if site == "kvhost.dma":
            fl.activate(fl.TargetedPlan({site: [0]}))
            evict_all(eng)
        else:
            evict_all(eng)
            fl.activate(fl.TargetedPlan({site: [0]}))
        got = run_one(eng, PROMPT)
        snap = fl.snapshot()
        fl.deactivate()
        assert got == want
        outs.append((got, state(eng), snap["injections_by_site"],
                     snap["occurrences_by_site"]))
    assert outs[1] == outs[0]
    kv = outs[1][1]["kvhost"]
    if site == "kvhost.corrupt":
        assert kv["corrupt_drops_total"] == 1 and kv["prefetches_total"] == 0
    else:
        assert kv["dma_failures_total"] == 1
    assert outs[1][1]["leases"] == []


@pytest.mark.parametrize("seed", [424242, 11])
def test_seeded_chaos_cycle_equals_jax(model, seed):
    """The JAX chaos cycle (tests/integration/test_kv_pressure.py) under
    one seeded plan over the three kvhost sites, on both engines with
    overlap=False (so a cancel after two steps lands at the same point):
    every request's outcome and tokens, the tier's counters, each site's
    crossings and injections equal; no wrong token, no page leaked."""
    kw = dict(ENGINE, num_slots=4, kv_num_blocks=11, kv_host_blocks=8,
              kv_offload_watermark=0.5, overlap=False)
    shared = list(range(1, 18))
    cases = [(shared + [30 + i], 10) for i in range(4)]
    cases += [([50 + i, 2, 7, 1], 14) for i in range(4)]
    sites = {s: 0.25 for s in KVHOST_SITES}
    outs = []
    jp, tp = model
    jcfg, tcfg = cfgs()
    for fl, eng in ((jfl, jsrv.ContinuousBatchEngine(jp, jcfg, **kw)),
                    (tfl, tsrv.ContinuousBatchEngine(tp, tcfg, device="cpu",
                                                     **kw))):
        fl.activate(fl.FaultPlan(seed, rate=0.0, sites=sites))
        rounds = []
        for _ in range(3):
            rids = [eng.submit(p, n) for p, n in cases]
            victim = eng.submit(shared + [99, 98], 12)
            for _ in range(2):
                eng.step()
            eng.cancel(victim)
            eng.run()
            rounds.append([(eng.result(r).tokens, eng.result(r).finish_reason)
                           for r in rids])
            evict_all(eng)
            rounds.append(state(eng))
        snap = fl.snapshot()
        fl.deactivate()
        outs.append((rounds, snap["injections_by_site"],
                     snap["occurrences_by_site"]))
        kv = eng.metrics()["kv_cache"]
        assert kv["blocks_used"] == kv["blocks_cached"] and not eng._leases
    assert outs[1] == outs[0]
    assert sum(outs[1][1].values()) >= 1
    assert outs[1][2]["kvhost.dma"] >= 2 and outs[1][2]["kvhost.fetch"] >= 2
    assert all(reason == "length" for rnd in outs[1][0][::2]
               for _, reason in rnd)


# ------------------------------------------------------ flight recorder

def test_prefetch_span_splits_queue_wait_and_prefill(model):
    jp, tp = model
    jcfg, tcfg = cfgs()
    kw = dict(ENGINE, kv_host_blocks=16, record_phase_events=True,
              phase_event_every=4)
    eng = tsrv.ContinuousBatchEngine(tp, tcfg, device="cpu", **kw)
    exp = ttr.InMemoryExporter()
    svc = serve.ServeService(eng, flight=tflight.FlightRecorder(
        ttr.Tracer("ktwe-serve", exp)))
    try:
        out = svc.generate({"prompt": PROMPT, "maxNewTokens": 6})
        assert out["status"] == "ok"
        assert not exp.spans("prefetch")
        with svc._lock:
            evict_all(eng)
        out2 = svc.generate({"prompt": PROMPT, "maxNewTokens": 6})
        assert out2["tokens"] == out["tokens"]
        pf = exp.spans("prefetch")
        assert len(pf) == 1
        qw = exp.spans("queue_wait")[-1]
        prefill = exp.spans("prefill")[-1]
        assert qw.end_time <= pf[0].start_time
        assert pf[0].end_time <= prefill.start_time + 1e-9
        assert 0.0 < pf[0].attributes["dma_end"]
        m = svc.metrics({})["metrics"]
        assert m["spans"]["phase_s"]["prefetch"]["p50"] >= 0.0
        fams = svc.prometheus_series()
        assert fams["ktwe_serving_kvhost_prefetches_total"] == 3.0
        req = eng.result(out2["requestId"])
        assert (req.submitted_at <= req.prefetch_started_at
                <= req.prefetch_done_at <= req.admitted_at)
    finally:
        svc.stop()
    # Both recorders turn the request's stamps into the same spans.
    base = 400.0
    req.submitted_at, req.prefetch_started_at = base, base + 0.01
    req.prefetch_done_at, req.admitted_at = base + 0.02, base + 0.03
    req.first_token_at, req.done_at = base + 0.05, base + 0.1
    req.phase_events = [(base + 0.04 + 0.001 * k, n, v)
                        for k, (_, n, v) in enumerate(req.phase_events)]
    ctx = tflight.FlightContext("a" * 32, "b" * 16, "", base + OFF - 0.005)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: WALL)
        mp.setattr(time, "perf_counter", lambda: PERF)
        got = _record(tflight, ttr, [req], [ctx], 0.0)
        want = _record(jflight, jtr, [req], [ctx], 0.0)
    assert got == want
    names = [sp["name"] for sp in got[1]]
    assert names.index("queue_wait") < names.index("prefetch")
    assert got[2]["phase_s"]["prefetch"]["p50"] > 0


# --------------------------------------------------------------- fleet

def _metrics(url):
    with urllib.request.urlopen(url + "/v1/metrics", timeout=30) as resp:
        return json.loads(resp.read())["metrics"]


def test_jax_registry_and_router_route_to_the_warm_torch_replica():
    extra = ["--kv-block-len", "8", "--kv-gossip-interval", "0.5"]
    cold = Replica(extra)
    warm = Replica(extra + ["--kv-host-blocks", "16"])
    reg = ReplicaRegistry(probe_interval_s=0.1, probe_timeout_s=5.0)
    try:
        prefix = [5, 9, 2, 71, 13, 8, 44, 3, 19, 27, 61, 90, 6, 12, 33, 1,
                  17, 22, 38, 55, 70, 81, 93, 4]       # 3 full blocks
        assert call(warm.url, "/v1/generate", {
            "prompt": prefix + [7], "maxNewTokens": 4})[0] == 200
        with warm.svc._lock:
            evict_all(warm.engine)            # now warm in the host tier
        time.sleep(0.6)
        ids = [reg.add(cold.url), reg.add(warm.url)]
        reg.probe_all()
        wl = reg.get(ids[1]).load
        assert wl.kv_bloom == _metrics(warm.url)["kvhost"]["bloom"] != ""
        assert (wl.kv_bloom_bits, wl.kv_bloom_hashes, wl.kv_block_len) == \
            (4096, 4, 8)
        assert reg.get(ids[0]).state is ReplicaState.HEALTHY
        pick = bloom_match_pick(prefix + [60, 61], reg.routable())
        assert pick is not None and pick.replica_id == ids[1]
        assert bloom_match_pick(list(range(90, 110)), reg.routable()) is None
        router = FleetRouter(reg, hedge_enabled=False)
        for tail in ([60], [61, 62], [63]):
            out = router.generate({"prompt": prefix + tail,
                                   "maxNewTokens": 4,
                                   "timeoutSeconds": 30})
            assert out["status"] == "ok"
        cm, wm = _metrics(cold.url), _metrics(warm.url)
        assert cm["lifetime"]["completed"] == 0
        assert wm["lifetime"]["completed"] == 4
        assert wm["kvhost"]["hits_total"] == 3
        assert wm["kv_cache"]["matched_tokens_total"] == 3 * 24
    finally:
        reg.stop()
        cold.close()
        warm.close()


# ----------------------------------------------------------- serve main

FLAGS = ("kv_host_blocks", "kv_offload_watermark", "kv_gossip_interval")


def test_flags_keys_and_parser_error_equal_the_jax_main(tmp_path, capsys):
    args = serve.build_parser().parse_args([])
    jdefaults = jknobs.defaults("serve")
    assert {k: getattr(args, k) for k in FLAGS} == \
        {k: jdefaults[k] for k in FLAGS}
    helps = {a.dest: a.help for a in serve.build_parser()._actions}
    jhelps = {a.dest: a.help for a in jserve.build_parser()._actions}
    assert {k: helps[k] for k in FLAGS} == {k: jhelps[k] for k in FLAGS}
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text("serve:\n  kv_host_blocks: 6\n"
                   "  kv_offload_watermark: 0.25\n"
                   "  kv_gossip_interval: 2\n  kv_block_len: 8\n")
    args = parse_with_config(serve.build_parser(), "serve",
                             ["--config", str(cfg), "--kv-host-blocks", "9"])
    assert [getattr(args, k) for k in FLAGS] == [9, 0.25, 2.0]
    eng = serve.make_engine(parse_with_config(
        serve.build_parser(), "serve",
        ["--config", str(cfg)] + ARGS), serve.build_engine(
            serve.build_parser().parse_args(ARGS)).params)
    assert (eng.kv_host_blocks, eng.kv_offload_watermark,
            eng.kv_gossip_interval) == (6, 0.25, 2.0)
    errs = []
    for main in (serve.main, jserve.main):
        with pytest.raises(SystemExit) as e:
            main(["--kv-host-blocks", "4", "--device", "cpu"]
                 if main is serve.main else ["--kv-host-blocks", "4"])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0].endswith(
        "error: --kv-host-blocks requires --kv-block-len > 0")
    assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]


def test_kvhost_route_ships_pages_between_serve_mains():
    extra = ["--kv-block-len", "8", "--kv-num-blocks", "9",
             "--kv-host-blocks", "16"]
    a_port, a_stop, a_th, a_res = _run_main(ARGS + extra)
    b_port, b_stop, b_th, b_res = _run_main(ARGS + extra)
    a, b = (f"http://127.0.0.1:{p}" for p in (a_port, b_port))
    try:
        body = {"prompt": PROMPT, "maxNewTokens": 8}
        code, want, _ = call(a, "/v1/generate", body)
        assert code == 200
        digests = tkv.prompt_digests(PROMPT, BL)
        assert call(a, "/v1/kvhost", {"digests": digests})[1]["entries"] == []
        # Evict A's pages into its tier with other prompts.
        for p in OTHERS * 2:
            assert call(a, "/v1/generate", {"prompt": p,
                                            "maxNewTokens": 30})[0] == 200
        code, out, _ = call(a, "/v1/kvhost", {"digests": digests})
        assert code == 200 and len(out["entries"]) >= 1
        shipped = len(out["entries"])
        code, imp, _ = call(b, "/v1/kvhost", {"entries": out["entries"]})
        assert (code, imp) == (200, {"status": "ok", "imported": shipped})
        code, got, _ = call(b, "/v1/generate", body)
        assert got["tokens"] == want["tokens"]
        mb = _metrics(b)["kvhost"]
        assert mb["imports_total"] == shipped and mb["hits_total"] >= 1
        assert mb["prefetches_total"] >= 1
        assert _metrics(a)["kvhost"]["exports_total"] == shipped
        code, err, _ = call(b, "/v1/kvhost", {})
        assert code == 400
        assert err["error"] == 'kvhost request needs "digests" or "entries"'
    finally:
        a_stop.set()
        b_stop.set()
        a_th.join(30)
        b_th.join(30)
    assert a_res.get("rc") == 0 and b_res.get("rc") == 0
