"""Priority admission, preemption and tenancy on the port, held to the JAX
package (tests/unit/test_tenancy.py's pins, re-run on the port, and the
JAX engine and cost engine on the same weights and inputs; CPU, f32).

- Cost: the port's calendar periods, per-tenant BLOCK budgets and
  TenantMeter against the JAX functions, on a frozen clock at each
  period and at dates that cross a month, a year, a leap February and a
  Sunday into Monday.
- Engine, dense and paged: interactive requests are admitted ahead of
  batch ones, FIFO within a class, in the JAX engine's order; an invalid
  priority is refused; under slot pressure the most recently submitted
  batch request is preempted (the same one as on the JAX engine, with the
  same tenancy carry); its resume on a second engine gives the JAX
  engine's uninterrupted greedy tokens; the carried hop count caps
  preemption (cap 2), cap 0 disables it; paged pool pressure preempts;
  the queue depth splits by class.
- The pipeline: a preempt with a chunk in flight (greedy and sampled)
  resumes to the uninterrupted stream; a victim whose first token has not
  landed carries no token and its slot's next owner gets only its own;
  every page comes back.
- The serve: the budget 429 and the queue 429 differ in reason and
  Retry-After; a resume bypasses the budget but is metered; an eject
  carries the tenancy keys and the tenant families render; a stream the
  client walks away from is metered; the x-ktwe-* headers set the
  tenancy and /v1/metrics has the `tenancy` block.
- C8 over HTTP: "priority": "bogus" is a 400; x-ktwe-priority: batch
  queues as batch; a resumed batch request's eject frame says batch with
  its carried hop count.

The port dispatches one chunk ahead of its commit, so the JAX tests'
fixed step counts do not carry over: every test steps until the
condition it needs holds, within a bound, and asserts what happened.
"""

import calendar
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_workload_enhancer_tpu.cmd.serve import \
    SERVING_FAMILIES as JAX_FAMILIES
from k8s_gpu_workload_enhancer_tpu.cost import cost_engine as jce
from k8s_gpu_workload_enhancer_tpu.fleet.wire import validate_frame
from k8s_gpu_workload_enhancer_tpu.models import serving as jsrv
from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.cost import cost_engine as tce
from k8s_gpu_workload_enhancer_tpu_torch.models import serving as tsrv
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.utils.httpjson import StatusError

import torch_parity  # noqa: F401  (one intra-op thread a process)

# tests/unit/test_tenancy.py's sizes.
DIMS = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
            d_ff=64, max_seq=64)
ENGINE = dict(num_slots=2, prefill_len=8, decode_chunk=2, max_queue=64,
              seed=0)
PAGED = {"kv_block_len": 8}
KINDS = [{}, PAGED]
KIND_IDS = ["dense", "paged"]


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jtf.TransformerConfig(**DIMS, dtype=jnp.float32, use_flash=False,
                                 use_ring_attention=False)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttf.TransformerConfig(**DIMS, dtype=torch.float32)
    return jcfg, jp, tcfg, ttf.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def port_engine(model, **kw):
    _, _, cfg, params = model
    return tsrv.ContinuousBatchEngine(params, cfg, device="cpu",
                                      **{**ENGINE, **kw})


def jax_engine(model, **kw):
    jcfg, jp, _, _ = model
    return jsrv.ContinuousBatchEngine(jp, jcfg, **{**ENGINE, **kw})


def step_until(eng, cond, limit=200):
    """Step `eng` until cond() holds; fail past `limit` steps."""
    for _ in range(limit):
        if cond():
            return
        eng.step()
    assert cond(), f"condition not reached within {limit} steps"


def tokens_of(eng, rid):
    return len(eng.result(rid).tokens)


def migrated(eng, rid):
    return eng.result(rid).finish_reason == "migrated"


def resume_on(eng, st):
    rid = eng.submit(st["prompt"], st["maxNewTokens"],
                     committed=st["committed"] or None,
                     prng_key=st["prngKey"], temperature=st["temperature"],
                     tenant=st["tenant"], priority=st["priority"],
                     preempted=st["preempted"])
    eng.run()
    return eng.result(rid)


def uninterrupted(eng, prompt, n, **kw):
    rid = eng.submit(prompt, n, **kw)
    eng.run()
    return eng.result(rid)


def pages_all_back(eng):
    kv = eng.metrics()["kv_cache"]
    return kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


# ---------------------------------------------------------------- cost

PERIODS = ["DAILY", "WEEKLY", "MONTHLY", "QUARTERLY"]
DATES = {
    "month-end": (2026, 1, 31, 23, 30, 0),
    "december": (2026, 12, 31, 22, 0, 0),
    "leap-february": (2028, 2, 29, 12, 0, 0),
    "sunday-night": (2026, 2, 15, 23, 59, 59),     # the next day a Monday
}


@pytest.fixture
def clock(monkeypatch):
    """A frozen time.time(), which both cost engines read."""
    now = {"t": 0.0}
    monkeypatch.setattr(time, "time", lambda: now["t"])
    return now


@pytest.mark.parametrize("when", list(DATES))
@pytest.mark.parametrize("period", PERIODS)
def test_period_boundaries_match_jax(period, when):
    now = float(calendar.timegm(DATES[when]))
    tp, jp = tce.BudgetPeriod[period], jce.BudgetPeriod[period]
    start, nxt = tce.period_start_of(tp, now), tce.period_next_start(tp, now)
    assert start == jce.period_start_of(jp, now)
    assert nxt == jce.period_next_start(jp, now)
    assert start <= now < nxt
    assert time.gmtime(nxt).tm_mday == 1 or period in ("DAILY", "WEEKLY")
    if period == "WEEKLY":
        assert time.gmtime(start).tm_wday == 0             # a Monday
    # The next period starts where the one after `now` begins.
    assert tce.period_start_of(tp, nxt) == nxt
    assert tce.period_next_start(tp, nxt - 1) == nxt


def _budgeted(mod, period, limit=1.0):
    eng = mod.CostEngine()
    b = eng.create_budget("tenant-alice", limit, mod.BudgetScope.TENANT,
                          scope_value="alice", period=mod.BudgetPeriod[period],
                          enforcement=mod.EnforcementPolicy.BLOCK)
    return eng, b


@pytest.mark.parametrize("when", list(DATES))
@pytest.mark.parametrize("period", PERIODS)
def test_serving_admission_blocks_and_resets_as_jax(clock, period, when):
    clock["t"] = float(calendar.timegm(DATES[when]))
    seen = []
    for mod in (tce, jce):
        eng, b = _budgeted(mod, period)
        trail = [eng.serving_admission("alice")]
        eng.add_serving_spend("alice", 2.0)
        trail.append(eng.serving_admission("alice"))
        trail.append(eng.serving_admission("bob"))
        # The calendar rolls over: the gate reopens and the spend resets.
        clock["t"] = mod.period_next_start(b.period, clock["t"])
        trail.append(eng.serving_admission("alice"))
        trail.append(b.current_spend)
        clock["t"] = float(calendar.timegm(DATES[when]))
        seen.append(trail)
    assert seen[0] == seen[1]
    (ok0, _, _), (ok1, reason, retry), bob, reopened, spend = seen[0]
    assert ok0 and not ok1 and "exhausted" in reason
    assert retry == max(1.0, tce.period_next_start(
        tce.BudgetPeriod[period], clock["t"]) - clock["t"])
    assert bob == (True, "", 0.0) and reopened[0] and spend == 0.0


@pytest.mark.parametrize("when", list(DATES))
@pytest.mark.parametrize("period", PERIODS)
def test_tenant_meter_prices_and_gates_as_jax(clock, period, when):
    clock["t"] = float(calendar.timegm(DATES[when]))
    seen = []
    for mod in (tce, jce):
        eng = mod.CostEngine()
        eng.create_budget("tenant-a", 1.0, mod.BudgetScope.TENANT,
                          scope_value="a", period=mod.BudgetPeriod[period],
                          enforcement=mod.EnforcementPolicy.BLOCK)
        meter = mod.TenantMeter(engine=eng, chip_hour_rate=3600.0)
        trail = [meter.record("a", "batch", tokens=10, chip_seconds=0.5),
                 meter.admission("a"),
                 meter.record("a", "interactive", tokens=3,
                              chip_seconds=1.0),
                 meter.admission("a"),
                 meter.record("a", "batch", 4, 0.25, count_request=False),
                 meter.record("b", "bogus", 1, 0.1),
                 meter.budget_rejections_total, meter.snapshot()]
        free = mod.TenantMeter()
        free.record("x", "interactive", 1, 0.1)
        trail.append(free.admission("x"))
        seen.append(trail)
    assert seen[0] == seen[1]
    trail = seen[0]
    assert trail[0] == pytest.approx(0.5)
    assert trail[1][0] and not trail[3][0] and trail[3][2] > 0
    assert trail[6] == 1
    snap = trail[7]
    assert snap["active_tenants"] == 2
    assert snap["by_priority"]["batch"] == {"requests": 1, "tokens": 14,
                                            "chip_seconds": 0.75}
    assert snap["tenants"]["b"]["interactive"]["requests"] == 1
    assert trail[8] == (True, "", 0.0)


# -------------------------------------------------------------- engine


def admission_order(eng):
    b1 = eng.submit([1, 2], 4, priority="batch")
    b2 = eng.submit([3, 4], 4, priority="batch")
    i1 = eng.submit([5, 6], 4, priority="interactive")
    i2 = eng.submit([7, 8], 4, priority="interactive")
    order = []
    for _ in range(100):
        if len(order) == 4:
            break
        eng.step()
        for r in (b1, b2, i1, i2):
            if eng.result(r).done and r not in order:
                order.append(r)
    assert order == [i1, i2, b1, b2]
    return order


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_priority_admission_order(model, kind):
    """Interactive requests are admitted ahead of batch ones, FIFO within
    each class, in the order the JAX engine admits them."""
    got = admission_order(port_engine(model, num_slots=1, **kind))
    assert got == admission_order(jax_engine(model, num_slots=1, **kind))


def test_invalid_priority_rejected(model):
    eng = port_engine(model)
    with pytest.raises(ValueError, match="priority") as got:
        eng.submit([1, 2], 4, priority="background")
    with pytest.raises(ValueError, match="priority") as want:
        jax_engine(model).submit([1, 2], 4, priority="background")
    assert str(got.value) == str(want.value)
    assert eng.metrics()["queued"] == 0


def lifo_victim(eng):
    """Two decoding batch requests and an interactive head: returns the
    victim's submit index, its state and the metrics after the
    interactive request finished."""
    b = [eng.submit([1, 2, 3], 20, tenant="t1", priority="batch"),
         eng.submit([4, 5, 6], 20, tenant="t2", priority="batch")]
    step_until(eng, lambda: all(tokens_of(eng, r) >= 1 for r in b))
    assert eng.slots_busy == 2
    i1 = eng.submit([7, 8], 4, priority="interactive")
    step_until(eng, lambda: any(migrated(eng, r) for r in b))
    victim = next(i for i, r in enumerate(b) if migrated(eng, r))
    rv = eng.result(b[victim])
    st = rv.resume_state
    assert st["reason"] == "preempt" and st["committed"] == rv.tokens
    assert st["maxNewTokens"] == 20
    assert eng.result(b[1 - victim]).finish_reason != "migrated"
    step_until(eng, lambda: eng.result(i1).done)
    assert eng.result(i1).finish_reason == "length"
    return victim, st, eng.metrics()


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_preempt_ejects_most_recent_batch_victim(model, kind):
    """Slot pressure with an interactive head: the most recently submitted
    batch request leaves as a reason="preempt" resume state carrying the
    tenancy keys; the older one keeps its slot. Same victim and the same
    carry as on the JAX engine."""
    victim, st, m = lifo_victim(port_engine(model, **kind))
    assert victim == 1
    assert (st["tenant"], st["priority"], st["preempted"]) == ("t2", "batch",
                                                                1)
    assert m["migration"]["preempted_total"] == 1
    assert m["migration"]["ejected_total"] == 1
    j_victim, j_st, j_m = lifo_victim(jax_engine(model, **kind))
    assert j_victim == victim
    assert {k: st[k] for k in ("tenant", "priority", "preempted")} == \
        {k: j_st[k] for k in ("tenant", "priority", "preempted")}
    assert j_m["migration"]["preempted_total"] == 1
    if kind:
        assert pages_all_back(port_engine(model, **kind))


class CountingGraph:
    """A CPU stand-in for the decode graph: runs the chunk, counts one
    capture (its first replay) and the replays after."""
    captures = replays = 0

    def replay(self, run):
        run()
        if self.captures:
            self.replays += 1
        else:
            self.captures = 1


def preempt_mid_decode(eng, temperature=None, min_tokens=3):
    """A batch request decoding alone in a one-slot engine, preempted by an
    interactive one while the batch's next chunk is in flight. Returns
    (batch id, interactive id, resume state)."""
    b = eng.submit([4, 5, 6], 20, tenant="t", priority="batch",
                   temperature=temperature)
    step_until(eng, lambda: tokens_of(eng, b) >= min_tokens)
    i = eng.submit([9, 9], 4, priority="interactive")
    assert eng._inflight is not None          # a chunk decodes for b
    assert [r.req_id for _, r in eng._inflight.snapshot] == [b]
    eng.step()                                # the admission preempts b
    st = eng.result(b).resume_state
    assert st is not None and st["reason"] == "preempt"
    k = len(st["committed"])
    assert 0 < k < 20
    eng.run()
    # The chunk in flight at the eject decoded for b: its tokens dropped.
    assert eng.result(b).tokens == st["committed"]
    assert eng.result(i).finish_reason == "length"
    return b, i, st


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_preempt_resume_bitwise_identical(model, kind):
    """The preempted batch request, resumed from its carry on a second
    engine, gives the JAX engine's uninterrupted greedy tokens exactly;
    one decode graph serves the preempting engine throughout."""
    want = uninterrupted(jax_engine(model, **kind), [4, 5, 6], 20,
                         priority="batch").tokens
    eng = port_engine(model, num_slots=1, **kind)
    eng._graph = CountingGraph()
    _, _, st = preempt_mid_decode(eng)
    assert eng._graph.captures == 1 and eng._graph.replays > 0
    assert st["committed"] == want[:len(st["committed"])]
    got = resume_on(port_engine(model, **kind), st)
    assert got.tokens == want
    assert got.emit_from == len(st["committed"])
    assert got.priority == "batch" and got.preempted == 1
    assert got.tenant == "t"
    if kind:
        assert pages_all_back(eng)


@pytest.mark.parametrize("temperature", [None, 0.8], ids=["greedy", "t0.8"])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_preempt_with_a_chunk_in_flight_resumes_the_stream(model, kind,
                                                           temperature):
    """The eject lands while a chunk still decodes for the victim: the
    carry holds only committed tokens, and the resumed stream, greedy or
    sampled, is the port's own uninterrupted stream bit for bit; the
    interactive request's tokens are its own uninterrupted ones."""
    eng = port_engine(model, num_slots=1, **kind)
    _, i, st = preempt_mid_decode(eng, temperature)
    want = uninterrupted(port_engine(model, **kind), [4, 5, 6], 20,
                         temperature=temperature, priority="batch")
    assert st["committed"] == want.tokens[:len(st["committed"])]
    assert resume_on(port_engine(model, seed=9, **kind), st).tokens == \
        want.tokens
    alone = uninterrupted(port_engine(model, **kind), [9, 9], 4)
    assert eng.result(i).tokens == alone.tokens
    if kind:
        assert eng._pool.free_count == eng._pool.capacity   # no full block


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_preempt_before_the_first_token_lands(model, kind):
    """A batch request preempted on the step after its admission, its
    first token still on its way to the host: the carry has no token,
    the pending entry is dropped, and the slot's new owner gets only its
    own first token."""
    eng = port_engine(model, num_slots=1, **kind)
    b = eng.submit([4, 5, 6], 20, priority="batch", temperature=0.8)
    eng.step()                                  # admitted, chunk in flight
    assert [p.req.req_id for p in eng._pending_first] == [b]
    assert eng.result(b).tokens == []
    i = eng.submit([9, 9], 4, priority="interactive")
    eng.step()
    st = eng.result(b).resume_state
    assert st is not None and st["committed"] == []
    assert [p.req.req_id for p in eng._pending_first] == []
    eng.run()
    assert eng.result(b).tokens == []
    alone = uninterrupted(port_engine(model, **kind), [9, 9], 4)
    assert eng.result(i).tokens == alone.tokens
    want = uninterrupted(port_engine(model, **kind), [4, 5, 6], 20,
                         temperature=0.8)
    assert resume_on(port_engine(model, **kind), st).tokens == want.tokens
    if kind:
        assert eng._pool.free_count == eng._pool.capacity


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_preempt_cap_makes_batch_non_preemptible(model, kind):
    """At preempt_cap the carried count makes the request run to
    completion: batch work always finishes."""
    eng = port_engine(model, num_slots=1, preempt_cap=2, **kind)
    b = eng.submit([1, 2, 3], 24, priority="batch", preempted=2)
    step_until(eng, lambda: tokens_of(eng, b) >= 3)
    i = eng.submit([5, 6], 4, priority="interactive")
    step_until(eng, lambda: tokens_of(eng, b) >= 12)
    assert eng.result(b).finish_reason is None        # still decoding
    assert eng.metrics()["queued_interactive"] == 1
    step_until(eng, lambda: eng.result(b).done and eng.result(i).done)
    assert eng.result(b).finish_reason == "length"
    assert eng.metrics()["migration"]["preempted_total"] == 0


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_preempt_cap_zero_disables(model, kind):
    eng = port_engine(model, num_slots=1, preempt_cap=0, **kind)
    b = eng.submit([1, 2, 3], 24, priority="batch")
    step_until(eng, lambda: tokens_of(eng, b) >= 3)
    i = eng.submit([5, 6], 4, priority="interactive")
    step_until(eng, lambda: tokens_of(eng, b) >= 12)
    assert eng.result(b).finish_reason is None
    step_until(eng, lambda: eng.result(i).done)
    assert eng.result(b).finish_reason == "length"
    assert eng.metrics()["migration"]["preempted_total"] == 0


def pool_pressure(eng):
    """Pool sized so the interactive admission defers while a batch lease
    holds the pages: ceil((3 + 36) / 8) = 5 of 7 pages for the batch,
    ceil((2 + 30) / 8) = 4 for the interactive request."""
    b = eng.submit([1, 2, 3], 36, tenant="t", priority="batch")
    step_until(eng, lambda: tokens_of(eng, b) >= 1)
    assert eng.slots_busy == 1
    i = eng.submit([5, 6], 30, priority="interactive")
    step_until(eng, lambda: migrated(eng, b))
    assert eng.result(b).resume_state["reason"] == "preempt"
    step_until(eng, lambda: eng.result(i).done)
    assert eng.result(i).finish_reason == "length"
    m = eng.metrics()
    assert m["migration"]["preempted_total"] == 1
    assert m["kv_cache"]["deferrals_total"] >= 1
    return eng.result(b).resume_state, eng.result(i).tokens


def test_paged_pool_pressure_preempts_batch(model):
    """A deferred interactive head preempts the batch lease; its pages
    admit the interactive request on a later step, as on the JAX engine,
    and every page comes back."""
    kw = dict(num_slots=2, kv_block_len=8, kv_num_blocks=8)
    eng = port_engine(model, **kw)
    st, toks = pool_pressure(eng)
    j_st, j_toks = pool_pressure(jax_engine(model, **kw))
    assert toks == j_toks
    assert (st["tenant"], st["priority"], st["preempted"]) == \
        (j_st["tenant"], j_st["priority"], j_st["preempted"]) == \
        ("t", "batch", 1)
    eng.run()
    assert eng._pool.free_count == eng._pool.capacity


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_queue_split_in_metrics(model, kind):
    eng = port_engine(model, num_slots=1, **kind)
    b = eng.submit([1, 2], 30, priority="batch")       # takes the slot
    step_until(eng, lambda: tokens_of(eng, b) >= 1)
    eng.submit([3, 4], 4, priority="batch")
    eng.submit([5, 6], 4, priority="interactive")
    m = eng.metrics()
    assert (m["queued_interactive"], m["queued_batch"], m["queued"]) == \
        (1, 1, 2)


# --------------------------------------------------------- serve layer


def make_service(model, meter=None, **kw):
    """A ServeService over a port engine, its loop parked: the test steps
    the engine by hand."""
    svc = serve.ServeService(port_engine(model, **kw), meter=meter,
                             default_tenant="anon")
    svc._stop.set()
    svc._wake.set()
    svc._thread.join(10)
    return svc


def step_service(svc, rid, limit=200):
    eng = svc._engine
    step_until(eng, lambda: eng.result(rid).done, limit)


def budget_meter(limit=0.000001):
    eng = tce.CostEngine()
    eng.create_budget("tenant-a", limit, tce.BudgetScope.TENANT,
                      scope_value="a", period=tce.BudgetPeriod.DAILY,
                      enforcement=tce.EnforcementPolicy.BLOCK)
    return tce.TenantMeter(engine=eng, chip_hour_rate=3.6e6)


def test_serve_budget_429_vs_queue_429(model):
    """The two 429s differ: reason "budget-exhausted" with a Retry-After
    to the period's end, against "queue-pressure" with the backlog's
    estimate."""
    meter = budget_meter()
    svc = make_service(model, meter=meter, num_slots=1, max_queue=1)
    try:
        g = svc.generate({"prompt": [1, 2], "maxNewTokens": 3,
                          "stream": True, "tenant": "a"})
        step_service(svc, 0)
        assert list(g)[-1]["status"] == "ok"
        with pytest.raises(StatusError) as ei:
            svc.generate({"prompt": [1, 2], "maxNewTokens": 3,
                          "tenant": "a"})
        assert ei.value.code == 429
        assert ei.value.reason == "budget-exhausted"
        assert ei.value.retry_after > 60
        assert str(ei.value).startswith("budget-exhausted: budget tenant-a")
        svc.generate({"prompt": [1, 2], "maxNewTokens": 40, "stream": True,
                      "tenant": "b"})
        svc._engine.step()                       # admitted: the slot
        svc.generate({"prompt": [3, 4], "maxNewTokens": 40, "stream": True,
                      "tenant": "b"})            # queued
        with pytest.raises(StatusError) as e2:
            svc.generate({"prompt": [5, 6], "maxNewTokens": 40,
                          "tenant": "b"})
        assert e2.value.code == 429 and e2.value.reason == "queue-pressure"
        assert e2.value.retry_after <= 30.0
        assert meter.budget_rejections_total == 1
    finally:
        svc.stop()


def test_serve_resume_bypasses_budget_and_meters(model):
    """A resume carry for an exhausted tenant is admitted (its first
    admission paid) and continues the stream exactly; its tokens meter to
    the carried tenant."""
    meter = budget_meter()
    svc = make_service(model, meter=meter)
    try:
        g = svc.generate({"prompt": [1, 2, 3], "maxNewTokens": 6,
                          "stream": True, "tenant": "a",
                          "priority": "batch"})
        step_service(svc, 0)
        out = list(g)[-1]
        assert out["status"] == "ok"
        assert not meter.admission("a")[0]            # now exhausted
        g2 = svc.generate({"resumeFrom": {
            "prompt": [1, 2, 3], "committed": out["tokens"][:2],
            "maxNewTokens": 6, "tenant": "a", "priority": "batch",
            "preempted": 1}, "stream": True})
        assert svc._engine.result(1).preempted == 1
        step_service(svc, 1)
        out2 = list(g2)[-1]
        assert out2["status"] == "ok" and out2["tokens"] == out["tokens"]
        a = meter.snapshot()["tenants"]["a"]["batch"]
        assert a["requests"] == 2 and a["tokens"] == 6 + 4
    finally:
        svc.stop()


def test_serve_eject_carries_tenancy_and_prometheus_families(model):
    """An ejected request's resume state carries tenant, priority and
    preempted (the wire contract), and every tenant and preemption family
    renders from the meter with the JAX name; a migrated view counts no
    request, and a request never admitted bills no chip-seconds."""
    meter = tce.TenantMeter()
    svc = make_service(model, meter=meter, num_slots=1)
    try:
        g = svc.generate({"prompt": [1, 2, 3], "maxNewTokens": 40,
                          "stream": True, "tenant": "bulk",
                          "priority": "batch", "_headers": {}})
        assert svc.eject({})["ejected"] == 1
        final = list(g)[-1]
        assert final["status"] == "migrate"
        res = final["resume"]
        assert (res["tenant"], res["priority"], res["preempted"]) == \
            ("bulk", "batch", 0)
        validate_frame(res, "resume")
        prom = svc.prometheus_series()
        for fam in ("ktwe_serving_tenant_requests_interactive_total",
                    "ktwe_serving_tenant_requests_batch_total",
                    "ktwe_serving_tenant_tokens_interactive_total",
                    "ktwe_serving_tenant_tokens_batch_total",
                    "ktwe_serving_tenant_chip_seconds_interactive_total",
                    "ktwe_serving_tenant_chip_seconds_batch_total",
                    "ktwe_serving_tenant_budget_rejections_total",
                    "ktwe_serving_tenants_active",
                    "ktwe_serving_queue_depth_interactive",
                    "ktwe_serving_queue_depth_batch",
                    "ktwe_serving_preemptions_total"):
            assert fam in prom and fam in JAX_FAMILIES
        m, busy, slots = svc._metrics()
        assert prom == {name: float(JAX_FAMILIES[name](m, busy, slots))
                        for name in prom}
        assert prom["ktwe_serving_tenant_requests_batch_total"] == 0.0
        assert prom["ktwe_serving_tenant_chip_seconds_batch_total"] == 0.0
        assert prom["ktwe_serving_tenants_active"] == 1.0
        assert len(serve.SERVING_FAMILIES) == 98
    finally:
        svc.stop()


def test_serve_stream_disconnect_still_meters(model):
    """A client walking away mid-stream cancels the request and still
    meters its partial tokens and slot residency."""
    meter = tce.TenantMeter()
    svc = make_service(model, meter=meter, num_slots=1)
    try:
        g = svc.generate({"prompt": [3, 5, 7], "maxNewTokens": 40,
                          "stream": True, "tenant": "walker",
                          "priority": "batch", "_headers": {}})
        step_until(svc._engine, lambda: tokens_of(svc._engine, 0) >= 3)
        first = next(g)
        assert first["tokens"]
        g.close()                                  # client disconnect
        assert svc._engine.result(0).cancelled
        w = meter.snapshot()["tenants"]["walker"]["batch"]
        assert w["requests"] == 1
        assert w["tokens"] >= len(first["tokens"])
        assert w["chip_seconds"] > 0.0
    finally:
        svc.stop()


def test_serve_header_tenancy_and_metrics_block(model):
    """x-ktwe-* headers set tenant and priority (the body wins); the
    /v1/metrics view carries the tenancy block and the queue split the
    registry parses; an unknown priority is refused."""
    meter = tce.TenantMeter()
    svc = make_service(model, meter=meter)
    try:
        g = svc.generate({"prompt": [1, 2], "maxNewTokens": 3,
                          "stream": True,
                          "_headers": {"x-ktwe-tenant": "hdr",
                                       "x-ktwe-priority": "batch"}})
        g2 = svc.generate({"prompt": [1, 2], "maxNewTokens": 3,
                           "stream": True, "tenant": "body",
                           "_headers": {"x-ktwe-tenant": "hdr"}})
        m = svc.metrics({})["metrics"]
        assert (m["queued_interactive"], m["queued_batch"]) == (1, 1)
        step_until(svc._engine, lambda: not svc._engine.active)
        assert list(g)[-1]["status"] == "ok"
        assert list(g2)[-1]["status"] == "ok"
        m = svc.metrics({})["metrics"]
        assert m["tenancy"]["tenants"]["hdr"]["batch"]["requests"] == 1
        assert m["tenancy"]["tenants"]["body"]["interactive"]["requests"] \
            == 1
        with pytest.raises(ValueError, match="priority"):
            svc.generate({"prompt": [1], "maxNewTokens": 2,
                          "priority": "bulk"})
        assert svc._engine.metrics()["queued"] == 0
    finally:
        svc.stop()


# ------------------------------------------------------------------ C8

SERVE_ARGS = ["--device", "cpu", "--port", "0", "--seed", "3",
              "--vocab-size", "128", "--d-model", "32", "--n-layers", "2",
              "--n-heads", "2", "--d-ff", "64", "--max-seq", "64",
              "--num-slots", "1", "--prefill-len", "8", "--decode-chunk",
              "2"]


@pytest.fixture
def replica():
    """The serve main's engine, meter and routes behind HTTP, its engine
    loop parked (stepped by hand)."""
    parser = serve.build_parser()
    args = parser.parse_args(SERVE_ARGS)
    svc = serve.ServeService(serve.build_engine(args),
                             meter=serve.build_meter(args, parser),
                             default_tenant=args.default_tenant)
    svc._stop.set()
    svc._wake.set()
    svc._thread.join(10)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield svc, f"http://127.0.0.1:{server.server_address[1]}"
    svc.stop()
    server.shutdown()
    server.server_close()
    th.join(10)


def post(url, body, headers=None):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, [json.loads(x) for x in
                                 resp.read().decode().splitlines()]
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read())]


def test_c8_bogus_priority_is_a_400(replica):
    svc, url = replica
    code, out = post(url, {"prompt": [1, 2], "maxNewTokens": 4,
                           "priority": "bogus"})
    assert code == 400 and "priority" in out[0]["error"]
    code, out = post(url, {"prompt": [1, 2], "maxNewTokens": 4},
                     {"x-ktwe-priority": "bogus"})
    assert code == 400
    assert svc._engine.metrics()["queued"] == 0


def test_c8_header_batch_queues_as_batch_and_the_eject_says_so(replica):
    """x-ktwe-priority: batch queues the request as batch; resumed from a
    preempt carry, its eject frame keeps batch, the tenant and the
    carried hop count."""
    svc, url = replica
    out = {}

    def send(key, body, headers=None):
        out[key] = post(url, dict(body, stream=True), headers)
    th = threading.Thread(target=send, args=("a", {
        "prompt": [1, 2, 3], "maxNewTokens": 30},
        {"x-ktwe-priority": "batch", "x-ktwe-tenant": "bulk"}))
    th.start()
    deadline = time.time() + 30
    while svc._engine.metrics()["queued_batch"] != 1:
        assert time.time() < deadline
        time.sleep(0.01)
    assert svc._engine.metrics()["queued_interactive"] == 0
    assert svc._engine.result(0).priority == "batch"
    svc.eject({})
    th.join(30)
    code, lines = out["a"]
    res = lines[-1]["resume"]
    assert (res["tenant"], res["priority"], res["preempted"]) == \
        ("bulk", "batch", 0)
    # The same request, as a preempt hop carried it: resumed and ejected
    # again, its frame keeps the class and the hop count.
    carry = dict(res, preempted=1, reason="preempt")
    th = threading.Thread(target=send, args=("b", {"resumeFrom": carry}))
    th.start()
    deadline = time.time() + 30
    while svc._engine.metrics()["queued"] != 1:
        assert time.time() < deadline
        time.sleep(0.01)
    step_until(svc._engine, lambda: tokens_of(svc._engine, 1) >= 1)
    svc.eject({})
    th.join(30)
    code, lines = out["b"]
    final = lines[-1]
    assert code == 200 and final["status"] == "migrate"
    validate_frame(final["resume"], "resume")
    assert (final["resume"]["tenant"], final["resume"]["priority"],
            final["resume"]["preempted"]) == ("bulk", "batch", 1)
