"""The flight recorder's engine half and its span trees, on the port and
on the JAX package, on the same weights (tests/test_torch_tenancy.py's
sizes, f32, on the CPU).

- Phase events: the port's engine with `record_phase_events` appends the
  JAX engine's events at the JAX boundaries. The (name, value) sequences
  of every request are equal exactly (for `commit`, its tokens and its
  `overlapped` flag; its host seconds are left out), dense and paged:
  staggered plain prefill at three decimations, the serialized commit,
  chunked prefill with the decode quantum, an eject and its resume, a
  preemption and the victim's resume, and the prefill role's handoff with
  its decode-side continuation. A weight swap with a chunk in flight keeps
  a request's event list. With the recorder off no request holds a list.
- `FlightRecorder.record` on the same engine request, under one frozen
  clock and one seeded id stream, exports the JAX recorder's span tree
  span for span, and `metrics()` (and `zero_metrics()`) are the JAX ones.
"""

import random
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.observability import flight as jflight
from k8s_gpu_workload_enhancer_tpu.utils import tracing as jtr
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.observability import flight as tflight
from k8s_gpu_workload_enhancer_tpu_torch.utils import tracing as ttr

import torch_parity  # noqa: F401  (one intra-op thread a process)

DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=64)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=4, seed=0,
              record_phase_events=True, phase_event_every=4)
PAGED = {"kv_block_len": 8}
KINDS = [{}, PAGED]
KIND_IDS = ["dense", "paged"]


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def engines(model, **kw):
    """(port engine, JAX engine) on the same weights and settings."""
    jcfg, jp, cfg, params = model
    kw = {**ENGINE, **kw}
    return (tsrv.ContinuousBatchEngine(params, cfg, device="cpu", **kw),
            jsrv.ContinuousBatchEngine(jp, jcfg, **kw))


def step_until(eng, cond, limit=300):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    assert cond(), f"condition not reached within {limit} steps"


def events(req) -> list:
    """A request's (name, value) phase events; a commit's value is
    (tokens, overlapped), its host seconds left out."""
    return [(name, (value[0], value[2]) if name == "commit" else value)
            for _, name, value in req.phase_events]


def resume(eng, st):
    rid = eng.submit(st["prompt"], st["maxNewTokens"],
                     committed=st["committed"], prng_key=st["prngKey"],
                     tenant=st["tenant"], priority=st["priority"],
                     preempted=st["preempted"])
    eng.run()
    return rid


# Scenarios: each drives one engine and returns its requests' event
# sequences (and, for a migration, those of the resuming engine).

def staggered(eng, _make):
    r0 = eng.submit([3, 17, 29, 5], 12)
    eng.step()
    r1 = eng.submit(list(range(2, 22)), 30)       # three prefill chunks
    eng.step()
    r2 = eng.submit([40, 2, 77], 9)
    eng.run()
    return [events(eng.result(r)) for r in (r0, r1, r2)]


def eject_and_resume(eng, make):
    rid = eng.submit(list(range(5, 15)), 30)
    step_until(eng, lambda: len(eng.result(rid).tokens) >= 9)
    st = eng.eject(rid)
    assert st["reason"] == "eject"
    dest = make()
    rid2 = resume(dest, st)
    return [events(eng.result(rid)), events(dest.result(rid2)),
            dest.result(rid2).tokens]


def preempt(eng, make):
    b = eng.submit([4, 5, 6], 24, tenant="t", priority="batch")
    step_until(eng, lambda: len(eng.result(b).tokens) >= 5)
    i = eng.submit([9, 9], 6, priority="interactive")
    step_until(eng, lambda: eng.result(b).finish_reason == "migrated")
    eng.run()
    st = eng.result(b).resume_state
    assert st["reason"] == "preempt"
    dest = make()
    rid2 = resume(dest, st)
    return [events(eng.result(b)), events(eng.result(i)),
            events(dest.result(rid2)), dest.result(rid2).tokens]


def handoff(eng, make):
    rids = [eng.submit([7, 1, 3], 12), eng.submit(list(range(30, 42)), 10)]
    eng.run()
    out = []
    for rid in rids:
        st = eng.result(rid).resume_state
        assert st["reason"] == "handoff" and len(st["committed"]) == 1
        dest = make()
        rid2 = resume(dest, st)
        out += [events(eng.result(rid)), events(dest.result(rid2))]
    return out


SCENARIOS = {
    "plain-every1": (staggered, {"phase_event_every": 1}, {}),
    "plain-every4": (staggered, {}, {}),
    "plain-every16": (staggered, {"phase_event_every": 16}, {}),
    "serialized": (staggered, {"overlap_commit": False}, {}),
    "chunked": (staggered, {"prefill_chunk_tokens": 4, "prefill_len": 16},
                {}),
    "eject": (eject_and_resume, {}, {}),
    "preempt": (preempt, {"num_slots": 1}, {}),
    "handoff": (handoff, {"handoff_first_token": True}, {}),
}


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_phase_events_equal_the_jax_engine(model, name, kind):
    drive, kw, dest_kw = SCENARIOS[name]
    port, jax_eng = engines(model, **kind, **kw)
    got = drive(port, lambda: engines(model, **kind, **dest_kw)[0])
    want = drive(jax_eng, lambda: engines(model, **kind, **dest_kw)[1])
    assert got == want
    names = {n for seq in got if isinstance(seq, list) and seq
             and isinstance(seq[0], tuple) for n, _ in seq}
    assert "prefill_chunk" in names
    if name == "plain-every1":
        # Decimation 1: an event pair at every commit with tokens.
        assert sum(n == "decode_step" for n, _ in got[1]) == \
            sum(n == "commit" for n, _ in got[1]) >= 7
        assert [v for n, v in got[1] if n == "prefill_chunk"] == [8, 16, 20]
    if name == "serialized":
        assert all(v[1] == 0 for seq in got for n, v in seq
                   if n == "commit")
    if name == "plain-every4":
        assert any(v[1] == 1 for seq in got for n, v in seq
                   if n == "commit")
    if name == "chunked":
        assert [v for n, v in got[1] if n == "prefill_chunk"] == [
            4, 8, 12, 16, 20]
    if name in ("eject", "preempt"):
        reason = "eject" if name == "eject" else "preempt"
        assert got[0][-1] == ("eject", reason)
        resumed = got[2] if name == "preempt" else got[1]
        assert resumed[0][0] == "resume" and resumed[0][1] > 0
    if name == "handoff":
        assert got[0] == [("prefill_chunk", 3), ("eject", "handoff")]
        assert got[1][0] == ("resume", 1)


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_swap_with_a_chunk_in_flight_keeps_the_event_list(model, kind):
    """swap_params (the same weights, as a fresh tree) lands while a chunk
    decodes for a request: the request keeps its list object and ends with
    the events of an unswapped JAX run."""
    _, _, cfg, params = model
    port, jax_eng = engines(model, **kind)
    want = staggered(jax_eng, None)[1]
    r0 = port.submit([3, 17, 29, 5], 12)
    port.step()
    r1 = port.submit(list(range(2, 22)), 30)
    step_until(port, lambda: len(port.result(r1).tokens) >= 5)
    log = port.result(r1).phase_events
    assert port._inflight is not None
    port.swap_params({k: (v.clone() if isinstance(v, torch.Tensor)
                          else {kk: vv.clone() for kk, vv in v.items()})
                      for k, v in params.items()})
    r2 = port.submit([40, 2, 77], 9)
    port.run()
    assert port.result(r1).phase_events is log
    assert events(port.result(r1)) == want
    assert port.result(r0).done and port.result(r2).done


def test_recorder_off_allocates_no_event_list(model):
    port, _ = engines(model, record_phase_events=False)
    rid = port.submit([1, 2, 3], 10)
    port.run()
    st = None
    rid2 = port.submit([4, 5], 20)
    step_until(port, lambda: len(port.result(rid2).tokens) >= 2)
    st = port.eject(rid2)
    rid3 = resume(port, st)
    assert all(port.result(r).phase_events is None
               for r in (rid, rid2, rid3))


WALL, PERF = 1_700_000_000.25, 500.5
OFF = WALL - PERF              # the recorders' perf -> wall calibration


@pytest.fixture
def frozen(monkeypatch):
    """One wall clock and one perf_counter for both packages."""
    monkeypatch.setattr(time, "time", lambda: WALL)
    monkeypatch.setattr(time, "perf_counter", lambda: PERF)


def _record(mod, trmod, reqs, ctxs, threshold):
    exp = trmod.InMemoryExporter()
    cap = trmod.SlowRequestCapture(exp, threshold_s=threshold,
                                   root_names=(mod.ROOT_SPAN_REPLICA,))
    rec = mod.FlightRecorder(trmod.Tracer("ktwe-serve", cap), capture=cap)
    random.seed(7)
    ids = [rec.record(r, c, stream=bool(i % 2))
           for i, (r, c) in enumerate(zip(reqs, ctxs))]
    return ids, [s.to_dict() for s in exp.spans()], rec.metrics(), \
        rec.slow_list()


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_flight_record_equals_the_jax_recorder(model, frozen, threshold):
    """Requests a real port engine served (a plain one, a resumed one, an
    ejected one, a handoff and one never admitted), given perf_counter
    stamps spread over a second, recorded by both recorders."""
    port, _ = engines(model)
    reqs = []
    r = port.submit(list(range(2, 22)), 12)
    port.run()
    reqs.append(port.result(r))
    r = port.submit([5, 6, 7], 20)
    step_until(port, lambda: len(port.result(r).tokens) >= 5)
    st = port.eject(r)
    reqs.append(port.result(r))
    reqs.append(port.result(resume(port, st)))
    hand, _ = engines(model, handoff_first_token=True)
    h = hand.submit([9, 8], 6)
    hand.run()
    reqs.append(hand.result(h))
    q = port.submit([1, 1], 4)
    port.cancel(q)
    reqs.append(port.result(q))
    # Stamps on the frozen perf clock: phase events, then the request's
    # own timestamps, spread so every phase has a duration.
    for i, req in enumerate(reqs):
        base = 400.0 + 10 * i
        req.submitted_at = base
        if req.admitted_at is not None:
            req.admitted_at = base + 0.01 * (i + 1)
        if req.first_token_at is not None:
            req.first_token_at = base + 0.03 * (i + 1)
        req.done_at = base + 0.1 * (i + 1)
        # The frozen clock gave every commit 0 host seconds: give them
        # some.
        req.phase_events = [
            (base + 0.001 * k, n,
             (v[0], 0.002 * (k + 1), v[2]) if n == "commit" else v)
            for k, (_, n, v) in enumerate(req.phase_events or [])]
    header = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    ctxs = [tflight.FlightContext(*(jtr.parse_traceparent(header)[0],
                                    f"{i + 1:016x}",
                                    jtr.parse_traceparent(header)[1]
                                    if i % 2 else "",
                                    # HTTP arrival 5 ms before submit
                                    400.0 + 10 * i + OFF - 0.005))
            for i in range(len(reqs))]
    got = _record(tflight, ttr, reqs, ctxs, threshold)
    want = _record(jflight, jtr, reqs, ctxs, threshold)
    assert got == want
    ids, spans, metrics, slow = got
    names = [s["name"] for s in spans]
    assert names.count("replica.generate") == len(reqs)
    assert {"admission", "queue_wait", "prefill", "decode", "eject",
            "handoff", "resume"} <= set(names)
    assert metrics["requests"] == len(reqs) and metrics["enabled"] == 1
    assert metrics["phase_s"]["commit"]["p50"] > 0
    assert bool(slow) == (threshold > 0)
    ctx = tflight.FlightRecorder(ttr.Tracer()).context(header, 5.0)
    assert (ctx.trace_id, ctx.parent_id, ctx.t0_wall) == (
        header.split("-")[1], header.split("-")[2], 5.0)
    assert tflight.zero_metrics() == jflight.zero_metrics()
    assert tflight.MARK_SPANS == jflight.MARK_SPANS
    assert (tflight.ROOT_SPAN_REPLICA, tflight.ROOT_SPAN_ROUTER) == (
        jflight.ROOT_SPAN_REPLICA, jflight.ROOT_SPAN_ROUTER)


def test_flight_record_reads_request_like_objects(frozen):
    """A bare object with the request fields (no engine) records as on the
    JAX recorder, the missing fields defaulted alike."""
    req = types.SimpleNamespace(
        req_id=4, prompt=[1, 2, 3], tokens=[5, 6, 7, 8], submitted_at=499.0,
        admitted_at=499.2, first_token_at=499.5, done_at=500.0,
        finish_reason="error", error="boom", cancelled=False, emit_from=1,
        tenant="t", priority="batch", preempted=1,
        phase_events=[(499.3, "prefill_chunk", 3),
                      (499.6, "decode_step", 4),
                      (499.6, "commit", (3, 0.002, 1)),
                      (499.9, "eject", "evacuate"),
                      (499.95, "eject", "not-a-mark")])
    ctx = tflight.FlightContext("a" * 32, "b" * 16, "", 498.9 + OFF)
    assert _record(tflight, ttr, [req], [ctx], 0.0) == \
        _record(jflight, jtr, [req], [ctx], 0.0)
