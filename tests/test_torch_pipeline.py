"""The port's decode hot path: the overlapped dispatch/commit pipeline,
lazy first tokens, the watchdog and the graph-safe sampler, against the
pins of the JAX package's tests/unit/test_decode_hotpath.py and against
the JAX engine on the same weights (CPU, f32).

- tokens AND logprobs bitwise identical with the pipeline on and off
  (overlap_commit), dense and paged, greedy and sampled;
- greedy transcripts equal to the JAX engine's, which runs its own
  pipeline (overlap_commit=True, as its tests run it);
- the hot-path accounting: overlap on reports overlapped commit seconds,
  off reports none;
- a commit fault fails only the request it touched; a watchdog trip
  under the pipeline fails the batch within its deadline; both engines
  then serve on; a decode graph that raises fails the batch and the chunk
  never runs eagerly in its place;
- eject, cancel and swap_params with a chunk in flight give the JAX
  engine's transcripts for the same sequence of calls, and a graphed
  engine's swap copies into the storage its graph captured;
- the sampler, a tensor function over pre-drawn Gumbel noise, equals the
  engine's former per-row sampler bit for bit;
- overlap=False (the JAX engine's knob) collects every chunk in the step
  that dispatched it: step for step the JAX engine's live slots, prefill
  offsets, tokens and counters, dense, paged, speculative and chunked.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.cmd.serve import \
    SERVING_FAMILIES as JAX_FAMILIES
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf

import torch_parity  # noqa: F401  (one intra-op thread a process)

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=64)
# The JAX pin's mixed workload: a sub-chunk prompt, a two-chunk prompt
# and a repetitive one through two slots; stop sequences that never match
# keep the per-token tail scan honest without changing transcripts.
PROMPTS = [[3, 17, 29, 5, 7], list(range(1, 12)), [5, 6] * 4]
GENS = [10, 8, 12]
STOP = [[999, 999, 999], [998, 998]]
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=3, seed=0)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, port cfg, [(jax params, port params)] for seeds 0 and 1)."""
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    pairs = []
    for seed in (0, 1):
        jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
        pairs.append((jp, ttf.params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, "cpu")))
    return jcfg, tcfg, pairs


def port_engine(params, cfg, **kw):
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu",
                                      **{**ENGINE, **kw})


def run_workload(eng, temperature=0.0):
    rids = [eng.submit(list(p), n, temperature=temperature, stop=STOP)
            for p, n in zip(PROMPTS, GENS)]
    eng.run()
    assert all(eng.result(r).done for r in rids)
    return [(eng.result(r).tokens, eng.result(r).logprobs) for r in rids]


def reference(params, cfg, prompt, n):
    out = tdec.generate(params, torch.as_tensor([prompt]), n, cfg)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "t0.8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_bitwise_identity_overlap_on_vs_off(models, paged, temperature):
    """The pipeline reorders host bookkeeping, never device math or
    sampling state: tokens and logprobs bitwise equal across the
    orderings."""
    _, cfg, [(_, params), _] = models
    kw = {"kv_block_len": 8} if paged else {}
    want = run_workload(port_engine(params, cfg, overlap_commit=False, **kw),
                        temperature)
    got = run_workload(port_engine(params, cfg, overlap_commit=True, **kw),
                       temperature)
    assert got == want, "overlap_commit=True diverged from False"
    if temperature == 0.0:
        assert [t for t, _ in want] == [reference(params, cfg, p, n)
                                        for p, n in zip(PROMPTS, GENS)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_matches_the_jax_engine(models, paged):
    jcfg, cfg, [(jp, params), _] = models
    kw = {"kv_block_len": 8} if paged else {}
    jeng = jsrv.ContinuousBatchEngine(jp, jcfg, overlap_commit=True,
                                      **ENGINE, **kw)
    want = run_workload(jeng)
    got = run_workload(port_engine(params, cfg, **kw))
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=1e-4)


def test_hotpath_accounting_overlap_attribution(models):
    _, cfg, [(_, params), _] = models
    engines = {}
    for on in (True, False):
        engines[on] = port_engine(params, cfg, overlap_commit=on)
        run_workload(engines[on])
    hp_on = engines[True].metrics()["hotpath"]
    hp_off = engines[False].metrics()["hotpath"]
    assert hp_on["overlap_commit"] and not hp_off["overlap_commit"]
    for hp in (hp_on, hp_off):
        assert hp["commit_rounds_total"] > 0
        assert hp["commit_s_total"] > 0.0
        assert hp["fetch_sync_s_total"] > 0.0
        assert hp["graphs_captured"] == hp["graph_replays"] == 0   # CPU
    assert hp_on["commit_overlapped_s_total"] > 0.0
    assert hp_off["commit_overlapped_s_total"] == 0.0
    # The drain tail commits on the sync path: overlapped is a subset.
    assert hp_on["commit_overlapped_s_total"] <= hp_on["commit_s_total"]


def test_commit_fault_contained_to_one_request(models, monkeypatch):
    """A host-side fault while committing ONE request's tokens fails that
    request alone (cause "commit"); its co-tenant of the same chunk and
    the chunk already dispatched go on bitwise correct, and the engine
    serves on."""
    _, cfg, [(_, params), _] = models
    prompts = ([3, 17, 29, 5], [40, 2, 77])
    want = [reference(params, cfg, p, 10) for p in prompts]
    eng = port_engine(params, cfg)
    r0, r1 = (eng.submit(list(p), 10) for p in prompts)
    real = eng._commit_tokens
    calls = []

    def commit(*a, **kw):
        calls.append(a[0].req_id)
        if len(calls) == 1:
            raise RuntimeError("injected commit fault")
        return real(*a, **kw)
    monkeypatch.setattr(eng, "_commit_tokens", commit)
    eng.run()
    monkeypatch.undo()
    req0, req1 = eng.result(r0), eng.result(r1)
    failed, survived = ((req0, req1) if req0.finish_reason == "error"
                        else (req1, req0))
    assert failed.req_id == calls[0] and "commit failed" in failed.error
    assert survived.finish_reason == "length"
    assert survived.tokens == want[survived.req_id]
    errors = eng.metrics()["resilience"]["errors"]
    assert errors["commit"] == 1
    assert errors["collect"] == errors["dispatch"] == 0
    r2 = eng.submit([9, 9, 10], 5)
    eng.run()
    assert eng.result(r2).tokens == reference(params, cfg, [9, 9, 10], 5)
    assert eng.slots_busy == 0 and not eng.active


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_watchdog_trips_under_the_pipeline(models, monkeypatch, paged):
    """With the pipeline on, a hang shows one step after the dispatch (at
    the deferred fetch); the deadline runs from that chunk's dispatch, so
    it trips within it instead of blocking, then the engine serves on."""
    _, cfg, [(_, params), _] = models
    kw = {"kv_block_len": 8} if paged else {}
    eng = port_engine(params, cfg, decode_chunk=2, watchdog_timeout=0.2,
                      **kw)
    r0 = eng.submit([3, 17, 29, 5], 8)
    monkeypatch.setattr(tsrv, "_chunk_ready", lambda inflight: False)
    t0 = time.perf_counter()
    eng.run()
    assert time.perf_counter() - t0 < 10, "the watchdog must not block"
    req = eng.result(r0)
    assert req.done and req.finish_reason == "error"
    assert "watchdog" in req.error
    m = eng.metrics()["resilience"]
    assert m["watchdog_trips"] >= 1
    assert m["errors"]["watchdog"] == m["watchdog_trips"]
    monkeypatch.undo()
    r1 = eng.submit([9, 9, 10], 5)
    eng.run()
    assert eng.result(r1).tokens == reference(params, cfg, [9, 9, 10], 5)
    if paged:
        assert eng._leases == {}


def _in_flight_sequence(eng, new_params):
    """Three requests through two slots; an eject and a cancel with a
    chunk in flight, a weight swap with a chunk in flight, then the
    ejected request resumed on the same engine. Returns every transcript
    and the resume state's committed tokens."""
    r0 = eng.submit([3, 17, 29, 5, 7], 14)
    r1 = eng.submit(list(range(1, 12)), 12)
    r2 = eng.submit([40, 2, 77], 10, temperature=0.8)
    for _ in range(3):
        eng.step()
    state = eng.eject(r0)
    assert eng.eject(r0) is state
    eng.step()
    eng.cancel(r1)
    eng.step()
    eng.swap_params(new_params)
    eng.step()
    r3 = eng.submit(state["prompt"], state["maxNewTokens"],
                    committed=state["committed"],
                    prng_key=state["prngKey"])
    eng.run()
    out = {"committed": state["committed"]}
    for name, rid in (("r1", r1), ("r2", r2), ("r3", r3)):
        r = eng.result(rid)
        out[name] = (r.tokens, r.finish_reason)
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eject_cancel_and_swap_in_flight_match_the_jax_engine(models,
                                                              paged):
    jcfg, cfg, [(ja, ta), (jb, tb)] = models
    kw = {"kv_block_len": 8} if paged else {}
    want = _in_flight_sequence(jsrv.ContinuousBatchEngine(
        ja, jcfg, overlap_commit=True, **ENGINE, **kw), jb)
    eng = port_engine(ta, cfg, **kw)
    got = _in_flight_sequence(eng, tb)
    assert 0 < len(want["committed"]) < 14
    assert want["r1"][1] == "cancelled" and want["r2"][1] == "length"
    # r2 samples: its tokens are the port's own (another PRNG), but its
    # length and the greedy transcripts are the JAX engine's.
    assert got["committed"] == want["committed"]
    assert got["r1"] == want["r1"]
    assert got["r3"] == want["r3"]
    assert len(got["r2"][0]) == len(want["r2"][0]) == 10
    assert eng.slots_busy == 0 and not eng.active
    if paged:
        assert eng._leases == {}


class _StorageGraph:
    """A decode graph's stand-in on the CPU: it runs the chunk on every
    replay, and holds the engine to what a captured graph needs, the
    param leaves' storage unchanged since the capture."""

    def __init__(self, eng):
        self.eng, self.ptrs = eng, None
        self.captures = self.replays = 0

    def _storage(self):
        out = []
        tsrv._map_leaves(lambda t: out.append(t.data_ptr()), self.eng.params)
        return out

    def replay(self, run):
        if self.ptrs is None:
            self.ptrs, self.captures = self._storage(), 1
        else:
            assert self._storage() == self.ptrs, "a leaf left its storage"
            self.replays += 1
        run()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graphed_swap_copies_into_the_captured_storage(models, paged):
    """swap_params on a graphed engine keeps its param tree and every
    leaf's storage and copies the new values in, in stream order: the
    same eject/cancel/swap sequence gives the eager engine's transcripts
    (which test_eject_cancel_and_swap_in_flight_match_the_jax_engine
    holds to the JAX engine's), and the tree it was built with then holds
    the new weights."""
    _, cfg, [(_, ta), (_, tb)] = models
    kw = {"kv_block_len": 8} if paged else {}
    want = _in_flight_sequence(port_engine(ta, cfg, **kw), tb)
    own = tsrv._map_leaves(torch.clone, ta)
    eng = port_engine(own, cfg, **kw)
    eng._graph = _StorageGraph(eng)
    got = _in_flight_sequence(eng, tb)
    assert got == want
    assert eng.params is own and eng._graph.replays > 0
    same = []
    tsrv._map_leaves(lambda t: same.append(t), own)
    new = []
    tsrv._map_leaves(lambda t: new.append(t), tb)
    assert all(torch.equal(a, b) for a, b in zip(same, new))


# The engine's former per-row sampler, copied as it was: a host branch on
# the temperatures, a torch.Generator per sampled row, a sync on the
# nucleus size.
def _per_row_sampler(logits, keys, counts, temps, top_ps, top_k,
                     enable_top_p):
    greedy = torch.argmax(logits, dim=-1)
    sampled = np.nonzero(np.asarray(temps) > 0.0)[0]
    if len(sampled) == 0:
        return greedy
    out = greedy.clone()
    for b in sampled:
        row = logits[b].float() / max(float(temps[b]), 1e-6)
        if top_k > 0:
            cutoff = torch.topk(row, top_k).values[-1]
            row = torch.where(row < cutoff, float("-inf"), row)
        if enable_top_p and float(top_ps[b]) < 1.0:
            probs = torch.softmax(row, dim=-1)
            sp = torch.sort(probs, descending=True).values
            keep = (torch.cumsum(sp, dim=-1) - sp) < float(top_ps[b])
            cutoff = sp[int(keep.sum()) - 1]
            row = torch.where(probs >= cutoff, row, float("-inf"))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(tsrv._mix64(keys[b][0], keys[b][1], counts[b]))
        u = torch.rand(row.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[b] = torch.argmax(row + gumbel)
    return out


@pytest.mark.parametrize("enable_top_p", [False, True])
@pytest.mark.parametrize("top_k", [0, 5, 300])
@pytest.mark.parametrize("scale", [1.0, 6.0])
def test_sampler_equals_the_per_row_sampler(top_k, enable_top_p, scale):
    """Over mixes of greedy and sampled rows, temperatures, top-k and
    nucleus masses (>= 1 keeps every token), at two logit scales, for
    several sample indices."""
    v = 512
    g = torch.Generator().manual_seed(7)
    logits = torch.randn((7, v), generator=g) * scale
    temps = np.asarray([0.0, 0.8, 1.3, 1e-7, 0.0, 2.0, 0.5], np.float32)
    top_ps = np.asarray([1.0, 0.9, 0.5, 1.0, 0.05, 0.999, 1.0], np.float32)
    keys = np.asarray([[i, 1000 + 7 * i] for i in range(7)], np.uint32)
    for index in (0, 1, 17):
        counts = np.arange(7) + index
        want = _per_row_sampler(logits, keys, counts, temps, top_ps, top_k,
                                enable_top_p)
        noise = torch.zeros((7, v))
        for b in range(7):
            if temps[b] > 0:
                tsrv._draw_gumbel(noise[b], keys[b], int(counts[b]))
        got = tsrv._sample(logits, torch.from_numpy(temps),
                           torch.from_numpy(top_ps), noise, top_k,
                           enable_top_p)
        assert torch.equal(got, want), (index, got, want)


def test_hot_path_families_have_the_jax_names():
    names = {"ktwe_serving_overlap_commit",
             "ktwe_serving_fetch_sync_seconds_total",
             "ktwe_serving_commit_seconds_total",
             "ktwe_serving_commit_overlapped_seconds_total",
             "ktwe_serving_commit_rounds_total",
             "ktwe_serving_request_errors_dispatch_total",
             "ktwe_serving_request_errors_collect_total",
             "ktwe_serving_request_errors_commit_total",
             "ktwe_serving_watchdog_trips_total",
             "ktwe_serving_request_errors_watchdog_total"}
    assert names <= set(serve.SERVING_FAMILIES) <= set(JAX_FAMILIES)
    assert len(serve.SERVING_FAMILIES) == 98


def test_a_failing_graph_fails_the_batch_and_never_runs_eagerly(models,
                                                                monkeypatch):
    """A capture or replay that raises is a dispatch fault: the batch
    fails under cause "dispatch" and the chunk is not run eagerly in its
    place (the engine stands in a graph that raises for the card's)."""
    _, cfg, [(_, params), _] = models
    eng = port_engine(params, cfg)
    eager = []
    monkeypatch.setattr(eng, "_run_chunk", lambda: eager.append(1))

    class Broken:
        captures = replays = 0

        def replay(self, run):
            raise RuntimeError("capture failed")
    eng._graph = Broken()
    rid = eng.submit([3, 17, 29, 5], 6)
    eng.run()
    req = eng.result(rid)
    assert req.finish_reason == "error" and "capture failed" in req.error
    assert eng.metrics()["resilience"]["errors"]["dispatch"] == 1
    assert not eager and not eng.active


def _strict_trace(eng) -> list:
    """The JAX overlap=False pins' step sequences (test_serving.py: a long
    prompt arriving while a slot decodes, idle admission stopping at the
    first live slot, the prefill reservation in slots_busy, the quantum
    under a backlog), recorded after every step: live slots, the prefill
    offset, slots_busy, each request's tokens, the lifetime counters,
    the spec block and whether a chunk is left in flight."""
    long_a = [(5 * i + 2) % DIMS["vocab_size"] for i in range(24)]
    long_b = [(11 * i + 1) % DIMS["vocab_size"] for i in range(24)]
    cases = [([3, 17, 29, 5], 12), (long_a, 8), ([5, 6] * 4, 10),
             (long_b, 6)]
    trace, rids = [], []

    def snap():
        m = eng.metrics()
        trace.append((
            sum(r is not None for r in eng._slot_req),
            None if eng._prefill is None else eng._prefill.offset,
            eng.slots_busy, [list(eng.result(r).tokens) for r in rids],
            {k: m["lifetime"][k] for k in ("completed", "tokens",
                                           "decode_steps",
                                           "prefill_chunks")},
            {k: m["spec"][k] for k in ("rounds_total", "bypass_rounds_total",
                                       "tokens_total", "k_hist")},
            eng._inflight is None))
    for i, (prompt, n) in enumerate(cases):
        rids.append(eng.submit(prompt, n))
        if i < 2:
            eng.step()
            snap()
    while eng.active:
        eng.step()
        snap()
    return trace


@pytest.mark.parametrize("kind", [
    {}, {"kv_block_len": 8}, {"spec_k": 2}, {"spec_k": 2, "kv_block_len": 8},
    {"prefill_chunk_tokens": 4, "decode_chunk": 8}],
    ids=["dense", "paged", "dense-spec", "paged-spec", "chunked"])
def test_overlap_false_collects_each_chunk_as_the_jax_engine(models, kind):
    """overlap=False (the JAX engine's knob): every chunk is collected in
    the step that dispatched it, so the port steps as the JAX engine does,
    step for step: the same live slots, prefill offsets, tokens, counters
    and spec block after every step, no chunk in flight between steps;
    and the tokens equal the overlapped engine's."""
    jcfg, cfg, [(jp, params), _] = models
    kw = dict(ENGINE, prefill_interleave=1, **kind)
    want = _strict_trace(jsrv.ContinuousBatchEngine(jp, jcfg, overlap=False,
                                                    **kw))
    got = _strict_trace(port_engine(params, cfg, overlap=False, **kw))
    assert got == want
    assert all(t[-1] for t in got)
    if "spec_k" in kind:
        assert got[-1][5]["rounds_total"] > 0
    overlapped = _strict_trace(port_engine(params, cfg, **kw))
    assert overlapped[-1][3] == got[-1][3]
    assert not all(t[-1] for t in overlapped) or "spec_k" in kind
