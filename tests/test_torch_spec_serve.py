"""Speculative decoding in the port's serving engine and serve main, held to
the JAX package on the same weights and inputs (CPU, f32; the sizes of
tests/unit/test_speculative.py's engine tests: vocab 128, d_model 32, 2
layers, max_seq 128).

- The verify program (`_spec_verify`, dense and paged) against the JAX
  `_spec_verify_chunk[_paged]` on the same cache state: equal tokens,
  emitted counts, next tokens and positions, logprobs and written K/V
  within 1e-5 (rows past a reservation in the trash page, spill rows).
- The engine, dense and paged: greedy tokens equal the JAX spec engine's
  and the spec-off engine's exactly, staggered admissions on repetitive
  prompts; the `spec` metrics block equals the JAX engine's under an
  oracle and an adversarial `drafter=`, adaptive on and off (the collapse
  to bypass chunks and the re-probe), with the commit serialized, with
  chunked prefill; sampled slots ride without drafting and their streams
  equal the spec-off engine's; an EOS inside an accepted burst; the budget
  never overshoots; a run to the spill row stays exact; the int8 and spill
  refusals; the verify round's graph (a CPU stand-in) captured once and
  kept across a weight swap; the `spec_round` phase events equal the JAX
  engine's; a FaultLab fault at a verify round's dispatch, collect or
  commit fails what it fails on the JAX engine.
- The serve main: `--spec-k`/`--spec-ngram` with the JAX knob defaults
  and `serve:` keys, `--spec-k` with `--int8-kv` the JAX parser error, a
  spec replica's `spec` block with the JAX keys, its 8
  `ktwe_serving_spec_*` families at the JAX table's values (98 served),
  tokens equal to a spec-off replica's, and the JAX
  `ReplicaRegistry._parse_load` reading its acceptance rate and effective
  tokens a step.
- Speculation under preemption, under eject and resume, and on a
  registered prefix (an oracle drafter): the JAX spec engine's tokens,
  `spec` blocks, migration counters and resume frames, and the spec-off
  engine's tokens.

Every engine test forces verify rounds (repetitive prompts or a
`drafter=`) and asserts that they ran and accepted drafts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.autopilot import knobs as jknobs
from k8s_gpu_workload_enhancer_tpu.cmd import serve as jserve
from k8s_gpu_workload_enhancer_tpu.cmd.serve import \
    SERVING_FAMILIES as JAX_FAMILIES
from k8s_gpu_workload_enhancer_tpu.faultlab import core as jfl
from k8s_gpu_workload_enhancer_tpu.fleet.registry import ReplicaRegistry
from k8s_gpu_workload_enhancer_tpu.models import decode as jdec
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu_torch import faultlab as tfl
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.models import decode as tdec
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.ops.attention import \
    rope_frequencies
from k8s_gpu_workload_enhancer_tpu_torch.utils.config import parse_with_config

import torch_parity  # noqa: F401  (one intra-op thread a process)
from test_torch_serve_fleet import (ARGS, _free_port, _run_main, _scrape,
                                    call)

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=128)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=4)
KINDS = [{}, {"kv_block_len": 8}]
KIND_IDS = ["dense", "paged"]
PROMPTS = [[40 + i, 2, 7, 1, 3] for i in range(5)]
LENS = [60, 45, 50, 30, 55]
V = DIMS["vocab_size"]


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(autouse=True)
def inert_after():
    yield
    jfl.deactivate()
    tfl.deactivate()


def port_engine(model, **kw):
    _, _, cfg, params = model
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu",
                                      **{**ENGINE, **kw})


def jax_engine(model, **kw):
    jcfg, jp, _, _ = model
    return jsrv.ContinuousBatchEngine(jp, jcfg, **{**ENGINE, **kw})


def staggered(eng, prompts=PROMPTS, lens=LENS, **sub):
    """Submit each request one step after the last, then drain; returns
    (tokens per request, the spec block, lifetime)."""
    rids = []
    for p, n in zip(prompts, lens):
        rids.append(eng.submit(p, n, **sub))
        eng.step()
    eng.run()
    m = eng.metrics()
    return ([eng.result(r).tokens for r in rids], m["spec"],
            m["lifetime"])


_REFERENCE = {}


def reference(model, prompt, n):
    """The JAX package's single-stream greedy continuation (the module's
    one model, so memoized by prompt and length)."""
    key = (tuple(prompt), n)
    if key not in _REFERENCE:
        jcfg, jp, _, _ = model
        out = jdec.generate(jp, jnp.asarray([prompt], jnp.int32), n, jcfg,
                            max_seq=jcfg.max_seq)
        _REFERENCE[key] = np.asarray(out)[0, len(prompt):].tolist()
    return list(_REFERENCE[key])


def oracle_for(model, prompts, lens):
    """A perfect drafter over the requests' reference continuations."""
    want = {tuple(p): reference(model, p, n) for p, n in zip(prompts, lens)}

    def oracle(context, k):
        for p, w in want.items():
            if tuple(context[:len(p)]) == p:
                done = len(context) - len(p)
                return w[done:done + k]
        return []
    return oracle


def wrong(context, k):
    """An adversarial drafter: never the target's token here."""
    return [(int(context[-1]) + 1) % V] * k


def pages_all_back(eng):
    kv = eng.metrics()["kv_cache"]
    return kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


# ---------------------------------------------------------- verify program

def _cache_state(rng, kind, b, s_max, nkh, hd, n_layers):
    """A seeded (L, B, S, KH, D) dense cache, or a paged pool of 8-row
    pages with each slot's table (slot 2's reservation ends early, its
    later entries the trash page)."""
    if not kind:
        shape = (n_layers, b, s_max, nkh, hd)
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in "kv"], None
    bl, mb = 8, s_max // 8
    nb = b * mb + 1
    shape = (n_layers, nb, bl, nkh, hd)
    leaves = [rng.standard_normal(shape).astype(np.float32) for _ in "kv"]
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    table[2, 6:] = 0
    return leaves, table


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("where", ["middle", "end"])
def test_verify_program_equals_jax(model, kind, where):
    jcfg, jp, tcfg, tp = model
    b, k, s_max = 3, 4, DIMS["max_seq"]
    t = k + 1
    rng = np.random.default_rng(1 + len(where))
    leaves, table = _cache_state(rng, kind, b, s_max, tcfg.n_kv_heads,
                                 tcfg.head_dim, tcfg.n_layers)
    pos = np.asarray([5, 40, 45] if where == "middle"
                     else [s_max - 6, s_max - 3, 45], np.int64)
    block = rng.integers(0, V, (b, t))
    dlen = np.asarray([4, 2, 3])
    freqs = rope_frequencies(tcfg.head_dim, s_max, tcfg.rope_theta, "cpu")
    sampling = tsrv._Sampling(torch.zeros(b), torch.ones(b),
                              torch.zeros(1, b, V))
    bl = 8 if kind else 0

    def port(blk):
        cache = tdec.KVCache(*(torch.from_numpy(x.copy()) for x in leaves))
        packed, cur, p = tsrv._spec_verify(
            tp, cache, torch.from_numpy(blk), torch.from_numpy(dlen),
            torch.from_numpy(pos), tcfg, freqs, sampling,
            torch.from_numpy(table) if kind else None, bl)
        return packed.numpy(), cur.numpy(), p.numpy(), cache

    # Slot 0's drafts are the target's own tokens (all accepted), slot 1's
    # first draft is (one accepted), slot 2's are noise.
    for i in range(k):
        out = port(block)[0][:, :t]
        block[0, i + 1] = out[0, i]
        if i == 0:
            block[1, 1] = out[1, 0]
    packed, cur, p, cache = port(block)
    args = (jnp.asarray(block, jnp.int32), jnp.asarray(dlen, jnp.int32),
            jnp.asarray(pos, jnp.int32), jnp.zeros((b, 2), jnp.uint32),
            jnp.zeros(b, jnp.int32), jnp.zeros(b, jnp.float32),
            jnp.ones(b, jnp.float32))
    jcache = jdec.KVCache(k=jnp.asarray(leaves[0]), v=jnp.asarray(leaves[1]))
    if kind:
        jc, jcur, jpos, _, jpacked = jsrv._spec_verify_chunk_paged(
            jp, jcache, jnp.asarray(table), *args, jcfg, 0, False, bl)
    else:
        jc, jcur, jpos, _, jpacked = jsrv._spec_verify_chunk(
            jp, jcache, *args, jcfg, 0, False)
    jpacked = np.asarray(jpacked)
    np.testing.assert_array_equal(packed[:, :t], jpacked[:, :t])
    np.testing.assert_array_equal(packed[:, 2 * t], jpacked[:, 2 * t])
    assert packed[:, 2 * t].tolist()[:2] == [k + 1, 2]
    np.testing.assert_allclose(
        np.ascontiguousarray(packed[:, t:2 * t]).view(np.float32),
        np.ascontiguousarray(jpacked[:, t:2 * t]).view(np.float32),
        atol=1e-5, rtol=0)
    assert cur.tolist() == np.asarray(jcur).tolist()
    assert p.tolist() == np.asarray(jpos).tolist()
    for got, want in zip(cache.leaves(), (jc.k, jc.v)):
        got, want = got.numpy(), np.asarray(want)
        if kind:
            # The trash page takes rows past a reservation, in any order.
            got, want = got[:, 1:], want[:, 1:]
        else:
            got, want = got[:, :, :s_max - 1], want[:, :, :s_max - 1]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_greedy_equals_jax_spec_engine_and_spec_off(model, kind):
    got = staggered(port_engine(model, spec_k=4, **kind))
    want = staggered(jax_engine(model, spec_k=4, **kind))
    off = staggered(port_engine(model, **kind))
    assert got[0] == want[0] == off[0]
    assert got[0] == [reference(model, p, n) for p, n in zip(PROMPTS, LENS)]
    assert got[1] == want[1] and got[2] == want[2]
    spec = got[1]
    assert spec["rounds_total"] > 0 and spec["draft_accepted_total"] > 0
    assert spec["tokens_per_round"] > 1.5 and sum(spec["k_hist"]) > 0
    assert got[2]["decode_steps"] < off[2]["decode_steps"]
    assert off[1]["rounds_total"] == 0 and not off[1]["enabled"]
    assert off[1]["effective_tokens_per_step"] == 1.0


METRICS = {"oracle": ("oracle", {}), "oracle-fixed": ("oracle",
                                                      {"spec_adaptive": False}),
           "wrong": ("wrong", {}), "wrong-fixed": ("wrong",
                                                   {"spec_adaptive": False}),
           "serialized": ("oracle", {"overlap_commit": False}),
           "chunked": ("ngram", {"prefill_chunk_tokens": 4,
                                 "prefill_len": 16})}


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("name", list(METRICS))
def test_spec_metrics_equal_jax(model, name, kind):
    drafter_name, kw = METRICS[name]
    prompts, lens = PROMPTS[:4], [60, 70, 40, 64]
    drafter = {"oracle": oracle_for(model, prompts, lens), "wrong": wrong,
               "ngram": None}[drafter_name]
    kw = {**kw, **kind, "spec_k": 3 if "fixed" in name else 4}
    if drafter is not None:
        kw["drafter"] = drafter
    got = staggered(port_engine(model, **kw), prompts, lens)
    want = staggered(jax_engine(model, **kw), prompts, lens)
    assert got == want
    assert got[0] == [reference(model, p, n) for p, n in zip(prompts, lens)]
    spec = got[1]
    assert spec["rounds_total"] > 0
    if drafter_name == "oracle":
        assert spec["acceptance_rate"] == 1.0
        assert spec["draft_accepted_total"] > 0
    if name == "wrong":
        # Collapse to bypass chunks, then at least one re-probe (a streak
        # of 8 bypass rounds re-arms every live slot at one draft).
        assert spec["draft_accepted_total"] == 0
        assert spec["bypass_rounds_total"] >= 8 and spec["k_hist"][1] > 0
    if name == "wrong-fixed":
        # A fixed k never shrinks: only a request's last tokens (its budget)
        # cut a draft short or leave a round with nothing to draft.
        assert spec["k_hist"][3] > 0
        assert sum(spec["k_hist"][1:3]) <= 2 * len(prompts)
        assert spec["bypass_rounds_total"] <= len(prompts)
    if name == "chunked":
        assert spec["draft_accepted_total"] > 0


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_sampled_slots_ride_and_keep_their_stream(model, kind):
    """Sampled slots never draft; they take one token a round from row 0
    with the noise of their sample index, so every stream, greedy and
    sampled, equals the spec-off engine's; greedy ones the JAX engine's."""
    def run(**kw):
        eng = port_engine(model, num_slots=4, **kind, **kw)
        rids = []
        for i, p in enumerate(PROMPTS[:4]):
            rids.append(eng.submit(p, 40, temperature=0.9 if i % 2 else None,
                                   prng_key=[3, i]))
            eng.step()
        eng.run()
        return [eng.result(r).tokens for r in rids], eng.metrics()["spec"]
    got, spec = run(spec_k=4)
    want, _ = run()
    assert got == want
    assert spec["rounds_total"] > 0 and spec["draft_accepted_total"] > 0
    assert spec["k_hist"][0] > 0          # the sampled slots rode along
    for i in (0, 2):
        assert got[i] == reference(model, PROMPTS[i], 40)
    assert all(len(t) == 40 for t in got)


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_eos_inside_an_accepted_burst(model, kind):
    prompt, n = [3, 17, 29, 5], 40
    ref = reference(model, prompt, n)
    eos = ref[14]
    want = ref[:ref.index(eos) + 1]
    oracle = oracle_for(model, [prompt], [n])
    outs = []
    for make in (port_engine, jax_engine):
        eng = make(model, num_slots=1, spec_k=4, eos_id=eos, drafter=oracle,
                   **kind)
        rid = eng.submit(prompt, n)
        eng.run()
        r = eng.result(rid)
        rid2 = eng.submit([9, 9], 6)
        eng.run()
        outs.append((r.finish_reason, r.tokens, eng.result(rid2).tokens,
                     eng.metrics()["spec"]))
    assert outs[0] == outs[1]
    assert outs[0][0] == "eos" and outs[0][1] == want
    assert outs[0][2] == reference(model, [9, 9], 6)
    assert outs[0][3]["draft_accepted_total"] > 0


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_budget_never_overshoots(model, kind):
    prompt = [3, 17, 29, 5]
    for n in (2, 7, 11):
        eng = port_engine(model, num_slots=1, spec_k=4,
                          drafter=oracle_for(model, [prompt], [n]), **kind)
        rid = eng.submit(prompt, n)
        eng.run()
        r = eng.result(rid)
        assert r.tokens == reference(model, prompt, n)
        assert len(r.logprobs) == len(r.token_lat_s) == n
        assert r.finish_reason == "length"
        spec = eng.metrics()["spec"]
        if n > 2:
            # The verify rounds commit all but the first token, less a
            # last one that a bypass chunk may take.
            assert spec["rounds_total"] > 0
            assert spec["draft_accepted_total"] > 0
            assert n - 2 <= spec["tokens_total"] <= n - 1
        else:
            # A budget of one token after the first leaves nothing to
            # draft: the round bypasses.
            assert spec["rounds_total"] == 0 < spec["bypass_rounds_total"]
        if kind:
            assert pages_all_back(eng)


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_near_cache_end_stays_exact(model, kind):
    """prompt + max_new == max_seq - 1: the last rounds' writes clamp to
    the spill row (dense) or past the reservation (paged)."""
    prompt = [3, 17, 29, 5]
    n = DIMS["max_seq"] - 1 - len(prompt)
    want = reference(model, prompt, n)
    got = staggered(port_engine(model, num_slots=1, spec_k=4,
                                drafter=oracle_for(model, [prompt], [n]),
                                **kind), [prompt], [n])
    jgot = staggered(jax_engine(model, num_slots=1, spec_k=4,
                                drafter=oracle_for(model, [prompt], [n]),
                                **kind), [prompt], [n])
    assert got[0] == [want] and got == jgot
    assert got[1]["rounds_total"] > 0 and got[1]["acceptance_rate"] == 1.0


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_int8_and_spill_refusals(model, kind):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="int8") as got:
        tsrv.ContinuousBatchEngine(
            params, dataclasses.replace(cfg, kv_cache_int8=True),
            device="cpu", spec_k=2, **kind)
    jcfg, jp, _, _ = model
    with pytest.raises(ValueError) as want:
        jsrv.ContinuousBatchEngine(
            jp, dataclasses.replace(jcfg, kv_cache_int8=True), spec_k=2,
            **kind)
    assert str(got.value) == str(want.value)
    eng = port_engine(model, num_slots=1, spec_k=2, **kind)
    jeng = jax_engine(model, num_slots=1, spec_k=2, **kind)
    too_long = [1] * (DIMS["max_seq"] - 10)
    with pytest.raises(ValueError, match="spill") as got:
        eng.submit(too_long, 10)
    with pytest.raises(ValueError) as want:
        jeng.submit(too_long, 10)
    assert str(got.value) == str(want.value)
    eng.submit([1] * (DIMS["max_seq"] - 11), 10)     # one less: admitted
    port_engine(model, num_slots=1, **kind).submit(too_long, 10)


class StandInGraph:
    """The card's DecodeGraph on the CPU: the first replay captures (its
    warm-up runs the program), later ones replay."""

    def __init__(self):
        self.captures = self.replays = 0

    def replay(self, run):
        if self.captures:
            self.replays += 1
        else:
            self.captures = 1
        run()


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_verify_graph_captured_once_and_kept_across_a_swap(model, kind):
    """The verify round runs through its own graph (a CPU stand-in),
    captured on the first round; a swap copies the new weights into the
    captured storage and keeps it, and later rounds decode the new
    weights' tokens."""
    jcfg, jp, cfg, _ = model
    # Its own copy of the weights: the swap writes into them in place.
    params = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    eng = tsrv.ContinuousBatchEngine(params, cfg, device="cpu", spec_k=4,
                                     **ENGINE, **kind)
    eng._graph, eng._verify_graph = StandInGraph(), StandInGraph()
    first = staggered(eng, PROMPTS[:3], LENS[:3])
    assert eng._verify_graph.captures == 1
    assert eng._verify_graph.replays == first[1]["rounds_total"] - 1 > 0
    hp = eng.metrics()["hotpath"]
    assert hp["graphs_captured"] == 1 + eng._graph.captures
    new = ttf.params_from_numpy(jax.tree.map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(9), jcfg)), cfg,
        "cpu")
    leaf = params["embed"]
    eng.swap_params(new)
    assert eng.params["embed"] is leaf              # copied in place
    after = staggered(eng, PROMPTS[3:], LENS[3:])
    fresh = staggered(tsrv.ContinuousBatchEngine(new, cfg, device="cpu",
                                                 **ENGINE, **kind),
                      PROMPTS[3:], LENS[3:])
    assert after[0] == fresh[0]
    assert eng._verify_graph.captures == 1
    assert after[1]["rounds_total"] > first[1]["rounds_total"]


def _events(req):
    return [(name, (value[0], value[2]) if name == "commit" else value)
            for _, name, value in req.phase_events]


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("every", [1, 4])
def test_spec_round_phase_events_equal_jax(model, kind, every):
    kw = dict(spec_k=4, record_phase_events=True, phase_event_every=every,
              **kind)
    seqs = []
    for make in (port_engine, jax_engine):
        eng = make(model, **kw)
        rids = []
        for p, n in zip(PROMPTS[:3], LENS[:3]):
            rids.append(eng.submit(p, n))
            eng.step()
        eng.run()
        seqs.append([_events(eng.result(r)) for r in rids])
    assert seqs[0] == seqs[1]
    names = [n for seq in seqs[0] for n, _ in seq]
    assert "spec_round" in names and "prefill_chunk" in names
    rounds = [v for seq in seqs[0] for n, v in seq if n == "spec_round"]
    assert any(v[2] > 0 for v in rounds)


FAULTS = [("engine.dispatch", 2), ("engine.collect", 2),
          ("engine.commit", 3)]


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("site,occurrence", FAULTS,
                         ids=[s.split(".")[1] for s, _ in FAULTS])
def test_fault_at_a_verify_round_matches_jax(model, site, occurrence, kind):
    """With an oracle drafter every dispatch is a verify round; the fault
    fails what it fails on the JAX engine, the rest keep their tokens and
    the engine keeps serving."""
    prompts, lens = PROMPTS[:3], [30, 25, 20]
    oracle = oracle_for(model, prompts + [[9, 8, 7]], lens + [8])

    def scenario(eng, fl):
        fl.activate(fl.TargetedPlan({site: [occurrence]}))
        toks, spec, _ = staggered(eng, prompts, lens)
        r3 = eng.submit([9, 8, 7], 8)
        eng.run()
        out = [(eng.result(r).finish_reason, eng.result(r).error,
                eng.result(r).tokens) for r in range(3)]
        out.append(eng.result(r3).tokens)
        return out, eng.metrics()["resilience"]["errors"], spec
    got, terr, spec = scenario(port_engine(model, spec_k=4, drafter=oracle,
                                           **kind), tfl)
    want, jerr, jspec = scenario(jax_engine(model, spec_k=4, drafter=oracle,
                                            **kind), jfl)
    assert tfl.injections_total() == jfl.injections_total() == 1
    assert got == want and spec == jspec
    assert {c: terr[c] for c in terr} == {c: jerr.get(c, 0) for c in terr}
    cause = site.split(".")[1]
    assert terr[cause] == 1 and spec["rounds_total"] > 0
    failed = [o for o in got[:3] if o[0] == "error"]
    assert failed and f"site={site}" in failed[0][1]
    assert got[3] == reference(model, [9, 8, 7], 8)
    if kind:
        eng = port_engine(model, spec_k=4, drafter=oracle, **kind)
        assert pages_all_back(eng)


# ------------------------------------------------------------- serve main

def test_spec_flags_take_the_jax_knob_defaults_and_config(tmp_path):
    args = serve.build_parser().parse_args([])
    jdefaults = jknobs.defaults("serve")
    assert (args.spec_k, args.spec_ngram) == (
        jdefaults["spec_k"], jdefaults["spec_ngram"]) == (0, 3)
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text("serve:\n  spec_k: 2\n  spec_ngram: 2\n")
    args = parse_with_config(serve.build_parser(), "serve",
                             ["--config", str(cfg), "--spec-ngram", "4"])
    assert (args.spec_k, args.spec_ngram) == (2, 4)
    assert jknobs.load_config(str(cfg))["serve"] == {"spec_k": 2,
                                                      "spec_ngram": 2}
    engine = serve.make_engine(
        serve.build_parser().parse_args(ARGS + ["--spec-k", "3",
                                                "--spec-ngram", "2"]),
        serve.build_engine(serve.build_parser().parse_args(ARGS)).params)
    assert (engine.spec_k, engine._drafter.max_n) == (3, 2)


def test_spec_k_with_int8_kv_is_the_jax_parser_error(capsys):
    # The JAX main has no --device and no --seed.
    jargs = [a for i, a in enumerate(ARGS)
             if a not in ("--device", "--seed")
             and ARGS[i - 1] not in ("--device", "--seed")]
    errs = []
    for main, argv in ((jserve.main, jargs), (serve.main, ARGS)):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--spec-k", "4", "--int8-kv"])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[0].split(": error: ")[1] == errs[1].split(": error: ")[1]
    assert "--int8-kv" in errs[1]


@pytest.mark.parametrize("paged", [[], ["--kv-block-len", "8"]],
                         ids=KIND_IDS)
def test_spec_replica_serves_the_spec_block_and_families(paged):
    mport = _free_port()
    prompt = [5, 9, 2, 5, 9, 2, 5, 9]
    outs = {}
    for name, extra in (("off", []), ("on", ["--spec-k", "4",
                                              "--metrics-port", str(mport)])):
        port, stop, th, result = _run_main(ARGS + paged + extra)
        url = f"http://127.0.0.1:{port}"
        try:
            toks = [call(url, "/v1/generate", {
                "prompt": prompt[i:], "maxNewTokens": 30})[1]["tokens"]
                for i in range(3)]
            series = _scrape(mport) if name == "on" else None
            m = call(url, "/v1/metrics")[1]["metrics"]
        finally:
            stop.set()
            th.join(30)
        assert result.get("rc") == 0
        outs[name] = (toks, m, series)
    (off, m_off, _), (on, m, series) = outs["off"], outs["on"]
    assert on == off
    spec = m["spec"]
    jspec = jsrv.ContinuousBatchEngine(
        *(lambda c: (jtf.init_params(jax.random.PRNGKey(0), c), c))(
            jtf.TransformerConfig(**DIMS, dtype=jnp.float32,
                                  use_flash=False,
                                  use_ring_attention=False)),
        spec_k=4).metrics()["spec"]
    assert set(spec) == set(jspec)
    assert spec["enabled"] and spec["k"] == 4 and spec["rounds_total"] > 0
    assert spec["draft_accepted_total"] > 0
    assert m_off["spec"]["rounds_total"] == 0
    assert len(serve.SERVING_FAMILIES) == 98 == len(series)
    spec_names = [n for n in series if n.startswith("ktwe_serving_spec_")]
    assert len(spec_names) == 8
    for name in spec_names:
        assert series[name] == float(JAX_FAMILIES[name](
            m, m["slots_busy"], m["slots"])), name
    assert series["ktwe_serving_spec_rounds_total"] == spec["rounds_total"]
    snap = ReplicaRegistry._parse_load(m)
    assert snap.spec_acceptance_rate == spec["acceptance_rate"] > 0
    assert snap.effective_tokens_per_step == \
        spec["effective_tokens_per_step"] > 1.0
    off_snap = ReplicaRegistry._parse_load(m_off)
    assert off_snap.effective_tokens_per_step == 1.0


def _step_until(eng, cond, limit=400):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    assert cond(), f"condition not reached within {limit} steps"


def _resume(eng, st):
    return eng.submit(st["prompt"], st["maxNewTokens"],
                      committed=st["committed"], prng_key=st["prngKey"],
                      tenant=st["tenant"], priority=st["priority"],
                      preempted=st["preempted"])


def _spec_preempt(make):
    """One slot: a batch request decoding speculatively is preempted for an
    interactive arrival; its resume frame continues on a second engine."""
    eng = make(num_slots=1)
    b = eng.submit(PROMPTS[0], LENS[0], priority="batch", tenant="bulk")
    _step_until(eng, lambda: len(eng.result(b).tokens) >= 6)
    i = eng.submit(PROMPTS[1], 12)
    eng.run()
    rb, ri = eng.result(b), eng.result(i)
    other = make()
    r2 = _resume(other, rb.resume_state)
    other.run()
    return [(rb.tokens, rb.finish_reason, rb.resume_state),
            (ri.tokens, ri.finish_reason), other.result(r2).tokens,
            eng.metrics()["spec"], eng.metrics()["migration"],
            other.metrics()["spec"], other.metrics()["migration"]]


def _spec_eject(make):
    """A speculative stream ejected after 9 tokens resumes on another
    speculative engine."""
    eng = make()
    rids = [eng.submit(p, n) for p, n in zip(PROMPTS[:2], LENS[:2])]
    _step_until(eng, lambda: len(eng.result(rids[0]).tokens) >= 9)
    st = eng.eject(rids[0])
    eng.run()
    other = make()
    r2 = _resume(other, st)
    other.run()
    return [st, eng.result(rids[0]).tokens, eng.result(rids[1]).tokens,
            other.result(r2).tokens, eng.metrics()["spec"],
            eng.metrics()["migration"], other.metrics()["spec"],
            other.metrics()["migration"]]


def _spec_prefix(make):
    """Requests riding a registered prefix verify over its cached rows."""
    eng = make()
    pid = eng.register_prefix(PROMPTS[2] * 4)
    rids = [eng.submit(p, n, prefix_id=pid)
            for p, n in zip(PROMPTS[3:], LENS[3:])]
    eng.run()
    return [[eng.result(r).tokens for r in rids], eng.metrics()["spec"],
            eng.metrics()["prefix_cache"], eng.prefix_cached_len(pid)]


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("scenario", [_spec_preempt, _spec_eject,
                                      _spec_prefix],
                         ids=["preempt", "eject_resume", "prefix"])
def test_spec_under_migration_and_prefixes_equals_jax(model, scenario,
                                                      kind):
    """Speculation under preemption, under eject and resume, and on a
    registered prefix, under an oracle drafter: the JAX spec engine's
    tokens, `spec` blocks, migration counters and resume frames, and the
    spec-off engine's tokens."""
    # The prefix riders first: the oracle takes the first prompt a context
    # starts with, and each rider starts with PROMPTS[2].
    prompts = [PROMPTS[2] * 4 + p for p in PROMPTS[3:]] + PROMPTS
    oracle = oracle_for(model, prompts, LENS[3:] + LENS)

    def maker(engine):
        return lambda **kw: engine(model, spec_k=3, drafter=oracle,
                                   **{**kind, **kw})
    got = scenario(maker(port_engine))
    assert got == scenario(maker(jax_engine))
    spec = [x for x in got if isinstance(x, dict) and "rounds_total" in x]
    assert spec[0]["rounds_total"] > 0 and spec[0]["draft_accepted_total"] > 0
    off = scenario(lambda **kw: port_engine(model, **{**kind, **kw}))
    tokens = lambda out: [x for x in out if isinstance(x, list)]  # noqa: E731
    assert tokens(got) == tokens(off)
