"""The torch serve main's observability, over HTTP on the CPU, held to the
JAX package.

- Flags: `--trace-out`, `--span-out`, `--slo-capture-threshold`,
  `--optimizer-url`, `--telemetry-interval`, `--tenants` parse, take the
  JAX knob registry's defaults ($KTWE_TIMESLICE_TENANTS included), come from
  `--config`, and a telemetry interval under 1 s is refused.
- `--metrics-port` serves the JAX `SERVING_FAMILIES`, all 98 since the
  serving mesh, each with the JAX table's value; /v1/metrics' `spans` and `trace`
  blocks have the JAX serve's keys, on and off.
- Recorder on: a request's `traceparent` is adopted (its `traceId` in the
  final view), every final view's trace has one `replica.generate` root with
  its admission, queue_wait, prefill and decode children and one
  `prefill_chunk` event a prefill chunk; a trace record a terminal view and
  one `rejected` record for a budget 429 and for a queue-pressure 429; the
  three admin routes answer; the eject and resume marks share a trace.
- Recorder off: no tracing entry point is reached, no request holds an
  event list, no `traceId`, the families read 0 and each admin route
  answers the JAX serve's 400.
- The fleet: the JAX `FleetRouter`, with its own `Tracer` and
  `SlowRequestCapture`, in front of two torch replicas with their recorders
  on, splices a migration; the three span files, read with the JAX
  `read_spans`, rebuild one trace in which each replica root's parent is one
  of the router's spans for it (`router.hop` for the stream, as the JAX
  pin has it; `router.attempt` for a blocking request).
- Telemetry: `push_serving_telemetry` reaches the JAX optimizer's handler
  with the bearer token and `predict_time_slice` learns from it; a wrong
  token or a dead URL returns False; a serve main with `--optimizer-url`
  pushes on its own.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from k8s_gpu_workload_enhancer_tpu.autopilot import knobs as jknobs
from k8s_gpu_workload_enhancer_tpu.autopilot import trace as jtrace
from k8s_gpu_workload_enhancer_tpu.cmd import optimizer as jopt_main
from k8s_gpu_workload_enhancer_tpu.cmd import serve as jserve
from k8s_gpu_workload_enhancer_tpu.fleet.registry import ReplicaRegistry
from k8s_gpu_workload_enhancer_tpu.fleet.router import FleetRouter
from k8s_gpu_workload_enhancer_tpu.observability import flight as jflight
from k8s_gpu_workload_enhancer_tpu.optimizer.workload_optimizer import \
    OptimizerService
from k8s_gpu_workload_enhancer_tpu.utils import tracing as jtr
from k8s_gpu_workload_enhancer_tpu_torch.agent.optimizer_client import \
    HTTPOptimizerClient
from k8s_gpu_workload_enhancer_tpu_torch.autopilot import trace as ttrace
from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
from k8s_gpu_workload_enhancer_tpu_torch.observability import flight as tflight
from k8s_gpu_workload_enhancer_tpu_torch.utils import tracing as ttr
from k8s_gpu_workload_enhancer_tpu_torch.utils.config import parse_with_config

import torch_parity  # noqa: F401  (one intra-op thread a process)
from test_torch_serve_fleet import (ARGS, N, PROMPT, TRACEPARENT, Stream,
                                    _free_port, _router_stream, _run_main,
                                    _scrape, call, uninterrupted)

FLAGS = ("trace_out", "span_out", "slo_capture_threshold", "optimizer_url",
         "telemetry_interval", "tenants")
# The JAX serve's families whose source the port has not ported yet: none
# since the serving mesh (its five mesh families, evacuations and
# device-loss errors).
UNPORTED = ()


class ObsReplica:
    """A ServeService as the serve main builds it from `extra` flags
    (trace writer, flight recorder, span log), behind an HTTP server.
    `parked`: its engine loop is stopped and step() advances it."""

    def __init__(self, extra=(), parked=False, meter=None):
        args = serve.build_parser().parse_args(ARGS + list(extra))
        flight, span_log = serve.build_flight(args)
        self.svc = serve.ServeService(
            serve.build_engine(args), meter=meter,
            trace_writer=(ttrace.TraceWriter(args.trace_out)
                          if args.trace_out else None),
            flight=flight, span_log=span_log)
        self.engine = self.svc._engine
        if parked:
            self.svc._stop.set()
            self.svc._wake.set()
            self.svc._thread.join(10)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0),
                                          serve.make_handler(self.svc))
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def step(self):
        with self.svc._lock:
            self.engine.step()

    def close(self):
        self.svc.stop()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)
        for w in (self.svc._trace, self.svc._span_log):
            if w is not None:
                w.close()


@pytest.fixture
def replicas():
    made = []

    def make(extra=(), parked=False, meter=None):
        made.append(ObsReplica(extra, parked, meter))
        return made[-1]
    yield make
    for r in made:
        r.close()


def admin(url, path, body=None):
    """(status, reply) of an admin route (a POST; GET when body is None).
    The trace, span and slow-request answers are not wire frames (the
    fleet's `admin` frame schema does not cover them), so no frame check."""
    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------------------ flags

def test_flags_take_the_jax_knob_defaults(monkeypatch):
    monkeypatch.delenv("KTWE_TIMESLICE_TENANTS", raising=False)
    args = serve.build_parser().parse_args([])
    jdefaults = jknobs.defaults("serve")
    assert {k: getattr(args, k) for k in FLAGS} == \
        {k: jdefaults[k] for k in FLAGS}
    monkeypatch.setenv("KTWE_TIMESLICE_TENANTS", "3")
    assert serve.build_parser().parse_args([]).tenants == 3 == \
        jknobs.defaults("serve")["tenants"]
    args = serve.build_parser().parse_args([
        "--trace-out", "t.ndjson", "--span-out", "s.ndjson",
        "--slo-capture-threshold", "0.5", "--optimizer-url", "http://o:1",
        "--telemetry-interval", "2.5", "--tenants", "4"])
    assert [getattr(args, k) for k in FLAGS] == [
        "t.ndjson", "s.ndjson", 0.5, "http://o:1", 2.5, 4]


def test_config_sets_the_observability_keys(tmp_path):
    cfg = tmp_path / "ktwe.yaml"
    cfg.write_text('serve:\n  trace_out: "tr.ndjson"\n'
                   '  span_out: sp.ndjson\n  slo_capture_threshold: 0.25\n'
                   '  telemetry_interval: 5\n  tenants: 2\n'
                   '  optimizer_url: "http://opt:50051"\n')
    args = parse_with_config(serve.build_parser(), "serve",
                             ["--config", str(cfg), "--tenants", "6"])
    assert (args.trace_out, args.span_out, args.slo_capture_threshold,
            args.telemetry_interval, args.tenants, args.optimizer_url) == (
        "tr.ndjson", "sp.ndjson", 0.25, 5.0, 6, "http://opt:50051")
    jargs = jknobs.load_config(str(cfg))["serve"]
    assert {k: getattr(args, k) for k in jargs if k != "tenants"} == \
        {k: v for k, v in jargs.items() if k != "tenants"}


def test_telemetry_interval_under_a_second_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(ARGS + ["--telemetry-interval", "0.5"])
    assert e.value.code == 2
    assert "--telemetry-interval 0.5 is below 1.0" in capsys.readouterr().err
    with pytest.raises(ValueError, match="below bound 1.0"):
        jknobs.get("serve", "telemetry_interval").validate(0.5)


# ------------------------------------------------------- blocks, families

def test_metrics_blocks_have_the_jax_keys(tmp_path):
    """The `spans` and `trace` blocks of the port's ServeService against
    the JAX ServeService's methods on the same captures, off and on."""
    off = serve.ServeService.__new__(serve.ServeService)
    off._trace = off._flight = None
    joff = types.SimpleNamespace(_trace=None, _flight=None)
    assert off._trace_metrics() == jserve.ServeService._trace_metrics(joff)
    assert tflight.zero_metrics() == \
        jserve.ServeService._flight_metrics(joff)
    w = ttrace.TraceWriter(str(tmp_path / "t.ndjson"))
    w.record({"ts": 1.0, "prompt_tokens": 1, "max_new": 1})
    on = types.SimpleNamespace(_trace=w)
    assert serve.ServeService._trace_metrics(on) == \
        jserve.ServeService._trace_metrics(on)
    rec = tflight.FlightRecorder(ttr.Tracer())
    jrec = jflight.FlightRecorder(jtr.Tracer())
    assert set(rec.metrics()) == set(jrec.metrics())
    assert set(rec.metrics()["phase_s"]) == set(jrec.metrics()["phase_s"])


@pytest.fixture
def faultlabs_cleared():
    """JAX faultlab's and the port's process-wide counters cleared for
    this run (an inert plan activated, then deactivated), so a fault that
    another test file fired earlier in this process shows in neither
    side's `ktwe_fault_injections_total`; the earlier state is put back
    after."""
    from k8s_gpu_workload_enhancer_tpu import faultlab as jfaultlab
    from k8s_gpu_workload_enhancer_tpu.faultlab import core as jcore
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab as tfaultlab
    from k8s_gpu_workload_enhancer_tpu_torch.faultlab import core as tcore
    saved = []
    for lab, core in ((jfaultlab, jcore), (tfaultlab, tcore)):
        with core._lock:
            saved.append((core, core._active, dict(core._occurrences),
                          dict(core._injections), core._last))
        lab.activate(lab.FaultPlan(seed=0, rate=0.0))
        lab.deactivate()
    try:
        yield
    finally:
        for core, active, occurrences, injections, last in saved:
            with core._lock:
                core._occurrences.clear()
                core._occurrences.update(occurrences)
                core._injections.clear()
                core._injections.update(injections)
                core._last = last
            core._active = active


def test_families_are_the_jax_ones_less_the_unported(tmp_path,
                                                     faultlabs_cleared):
    assert len(UNPORTED) == 0
    assert set(serve.SERVING_FAMILIES) == \
        set(jserve.SERVING_FAMILIES) - set(UNPORTED)
    assert len(serve.SERVING_FAMILIES) == 98
    mport = _free_port()
    spans = tmp_path / "spans.ndjson"
    port, stop, th, result = _run_main(ARGS + [
        "--metrics-port", str(mport), "--span-out", str(spans),
        "--trace-out", str(tmp_path / "trace.ndjson"),
        "--slo-capture-threshold", "0.000001"])
    url = f"http://127.0.0.1:{port}"
    try:
        for i in range(3):
            assert call(url, "/v1/generate", {
                "prompt": PROMPT[i:], "maxNewTokens": 20})[1]["status"] \
                == "ok"
        time.sleep(0.1)
        series = _scrape(mport)
        m = call(url, "/v1/metrics")[1]["metrics"]
    finally:
        stop.set()
        th.join(30)
    assert result.get("rc") == 0
    assert set(series) == set(serve.SERVING_FAMILIES)
    for name, value in series.items():
        assert value == float(jserve.SERVING_FAMILIES[name](
            m, m["slots_busy"], m["slots"])), name
    assert series["ktwe_serving_trace_records_total"] == 3
    assert series["ktwe_serving_span_records_total"] == \
        len(jtr.read_spans(str(spans))) > 3
    assert series["ktwe_serving_slow_requests_captured_total"] == 3
    assert series["ktwe_serving_phase_seconds_prefill_p50"] > 0
    assert series["ktwe_serving_phase_seconds_decode_per_token_p99"] > 0
    assert series["ktwe_serving_phase_seconds_prefetch_p99"] == 0


# ---------------------------------------------------------- recorder on

def _tree(spans, trace_id):
    tree = [s for s in spans if s["traceId"] == trace_id]
    roots = [s for s in tree if s["name"] == "replica.generate"]
    assert len(roots) == 1, [s["name"] for s in tree]
    kids = {s["name"]: s for s in tree
            if s["parentSpanId"] == roots[0]["spanId"]}
    return roots[0], kids


def test_recorder_on_exports_span_trees_and_trace_records(replicas,
                                                          tmp_path):
    from k8s_gpu_workload_enhancer_tpu_torch.cost.cost_engine import (
        BudgetScope, CostEngine, EnforcementPolicy, TenantMeter)
    ce = CostEngine()
    ce.create_budget("tenant-probe", 0.0, BudgetScope.TENANT,
                     scope_value="probe",
                     enforcement=EnforcementPolicy.BLOCK)
    spans_path, trace_path = tmp_path / "s.ndjson", tmp_path / "t.ndjson"
    r = replicas(["--span-out", str(spans_path), "--trace-out",
                  str(trace_path), "--slo-capture-threshold", "0.000001",
                  "--max-queue", "1"], meter=TenantMeter(engine=ce))
    finals = [call(r.url, "/v1/generate", {"prompt": PROMPT,
                                           "maxNewTokens": 12},
                   headers={"traceparent": TRACEPARENT})[1]]
    finals.append(Stream(r.url, {"prompt": PROMPT[:5],
                                 "maxNewTokens": 9}).finish())
    finals.append(call(r.url, "/v1/generate", {
        "prompt": PROMPT[2:], "maxNewTokens": 10})[1])
    code, body, _ = call(r.url, "/v1/generate", {"prompt": PROMPT,
                                                 "maxNewTokens": 4},
                         headers={"x-ktwe-tenant": "probe"})
    assert code == 429 and body["reason"] == "budget-exhausted"
    # A queue-pressure 429: the loop parked, one request queued.
    r.svc._stop.set()
    r.svc._wake.set()
    r.svc._thread.join(10)
    queued = {}
    th = threading.Thread(target=lambda: queued.update(final=Stream(
        r.url, {"prompt": [1, 2], "maxNewTokens": 3}).finish()))
    th.start()
    deadline = time.time() + 10
    while r.engine.pending < 1:
        assert time.time() < deadline
        time.sleep(0.01)
    code, body, _ = call(r.url, "/v1/generate", {"prompt": [3, 4],
                                                 "maxNewTokens": 3})
    assert code == 429 and body["reason"] == "queue-pressure"
    while th.is_alive():
        assert time.time() < deadline + 20
        r.step()
        time.sleep(0.005)
    finals.append(queued["final"])
    assert finals[0]["traceId"] == TRACEPARENT.split("-")[1]
    assert finals[0]["traceparent"] == TRACEPARENT
    assert all(f["status"] == "ok" and len(f["traceId"]) == 32
               for f in finals)
    assert len({f["traceId"] for f in finals}) == len(finals)
    spans = jtr.read_spans(str(spans_path))
    for f in finals:
        root, kids = _tree(spans, f["traceId"])
        assert {"admission", "queue_wait", "prefill", "decode"} <= set(kids)
        req = r.engine.result(f["requestId"])
        chunks = -(-len(req.prompt) // r.engine.prefill_len)
        assert len([e for e in kids["prefill"]["events"]
                    if e["name"] == "prefill_chunk"]) == chunks
        assert root["attributes"]["tokens"] == len(f["tokens"])
        assert root["attributes"]["ttft_ms"] > 0
        assert kids["prefill"]["endTimeUnixNano"] <= \
            kids["decode"]["startTimeUnixNano"]
    root, _ = _tree(spans, finals[0]["traceId"])
    assert root["parentSpanId"] == TRACEPARENT.split("-")[2]
    recs = jtrace.read_trace(str(trace_path))
    assert len(recs) == len(finals) + 2
    rejected = [x for x in recs if x["status"] == "rejected"]
    assert sorted(x["reason"] for x in rejected) == [
        "budget-exhausted", "queue-pressure"]
    assert [x["output_tokens"] for x in recs if x["status"] == "ok"] == \
        [len(f["tokens"]) for f in finals]
    assert [x["stream"] for x in recs if x["status"] == "ok"] == \
        [False, True, False, True]
    assert all(0 < x["ttft_ms"] < 60_000 for x in recs
               if x["status"] == "ok")
    # The admin routes.
    code, st = admin(r.url, "/v1/admin/trace", {})
    assert code == 200 and st == {"status": "ok", "tracing": True,
                                  "records": len(recs),
                                  "path": str(trace_path)}
    assert admin(r.url, "/v1/admin/trace", {"action": "rotate"})[0] == 200
    assert not trace_path.exists() and len(list(tmp_path.glob(
        "t.ndjson.*"))) == 1
    assert admin(r.url, "/v1/admin/trace", {"action": "bogus"})[0] == 400
    code, st = admin(r.url, "/v1/admin/spans", {"action": "status"})
    assert code == 200 and st["spans"] is True and st["records"] == \
        len(spans)
    code, slow = admin(r.url, "/v1/admin/slow-requests")
    assert code == 200 and {x["traceId"] for x in slow["slow"]} == \
        {f["traceId"] for f in finals}
    m = call(r.url, "/v1/metrics")[1]["metrics"]
    assert m["spans"]["enabled"] == 1 and m["spans"]["requests"] == 4
    assert m["trace"] == {"enabled": 1, "records": len(recs), "dropped": 0,
                          "rotations": 1}


def test_eject_and_resume_marks_share_the_trace(replicas, tmp_path):
    """A stream ejected from A ends in a migrate frame whose view names
    its trace; the resume on B under the same traceparent joins it."""
    a = replicas(["--span-out", str(tmp_path / "a.ndjson")], parked=True)
    b = replicas(["--span-out", str(tmp_path / "b.ndjson")])
    s = Stream(a.url, {"prompt": PROMPT, "maxNewTokens": N},
               headers={"traceparent": TRACEPARENT})
    deadline = time.time() + 30
    while not a.engine.active:
        assert time.time() < deadline
        time.sleep(0.01)
    while len(a.engine.result(0).tokens) < 9:
        a.step()
    assert call(a.url, "/v1/admin/eject", {})[1]["ejected"] == 1
    final = s.finish()
    assert final["status"] == "migrate"
    out = call(b.url, "/v1/generate", {"resumeFrom": final["resume"]},
               headers={"traceparent": TRACEPARENT})[1]
    tid = TRACEPARENT.split("-")[1]
    assert final["traceId"] == out["traceId"] == tid
    ra, ka = _tree(jtr.read_spans(str(tmp_path / "a.ndjson")), tid)
    rb, kb = _tree(jtr.read_spans(str(tmp_path / "b.ndjson")), tid)
    assert "eject" in ka and ra["attributes"]["migrate.reason"] == "eject"
    assert "resume" in kb
    assert rb["attributes"]["resume.committed"] == len(
        final["resume"]["committed"])


# --------------------------------------------------------- recorder off

def test_recorder_off_reaches_no_tracing_code(replicas, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("tracing code reached with the recorder off")
    for owner, name in ((ttr.Tracer, "start_span"),
                        (ttr.JsonlExporter, "export"),
                        (ttr.SlowRequestCapture, "export"),
                        (tflight.FlightRecorder, "record"),
                        (tflight.FlightRecorder, "context"),
                        (ttrace.TraceWriter, "record")):
        monkeypatch.setattr(owner, name, boom)
    r = replicas()
    out = call(r.url, "/v1/generate", {"prompt": PROMPT, "maxNewTokens": 8},
               headers={"traceparent": TRACEPARENT})[1]
    final = Stream(r.url, {"prompt": PROMPT[:4],
                           "maxNewTokens": 6}).finish()
    assert out["status"] == final["status"] == "ok"
    assert "traceId" not in out and "traceId" not in final
    assert out["traceparent"] == TRACEPARENT
    assert all(r.engine.result(x["requestId"]).phase_events is None
               for x in (out, final))
    fams = r.svc.prometheus_series()
    assert all(fams[k] == 0 for k in fams if "_span_" in k
               or "phase_seconds" in k or "trace_records" in k
               or "slow_requests" in k)
    for path, body in (("/v1/admin/trace", {}), ("/v1/admin/spans", {}),
                       ("/v1/admin/slow-requests", None)):
        code, err = admin(r.url, path, body)
        assert code == 400
        jsvc = types.SimpleNamespace(_trace=None, _span_log=None,
                                     _flight=None)
        with pytest.raises(ValueError) as e:
            {"/v1/admin/trace": jserve.ServeService.admin_trace,
             "/v1/admin/spans": jserve.ServeService.admin_spans,
             "/v1/admin/slow-requests":
                 jserve.ServeService.slow_requests}[path](jsvc, {})
        assert err["error"] == str(e.value)


# ------------------------------------------------------------- the fleet

def _tracer(path, root_name):
    capture = jtr.SlowRequestCapture(jtr.JsonlExporter(path),
                                     root_names=(root_name,))
    return jtr.Tracer("router", capture), capture


def test_jax_router_and_two_torch_replicas_rebuild_one_trace(replicas,
                                                             tmp_path):
    paths = {n: str(tmp_path / f"{n}.ndjson") for n in ("router", "a", "b")}
    reps = [replicas(["--span-out", paths["a"]], parked=True),
            replicas(["--span-out", paths["b"]], parked=True)]
    want = uninterrupted(replicas().url)
    tracer, cap = _tracer(paths["router"], jflight.ROOT_SPAN_ROUTER)
    reg = ReplicaRegistry(probe_interval_s=0.1, probe_timeout_s=2.0)
    try:
        for r in reps:
            reg.add(r.url)
        reg.probe_all()
        router = FleetRouter(reg, hedge_enabled=False, tracer=tracer,
                             span_capture=cap)
        out = {}
        th = threading.Thread(target=_router_stream, args=(router, {
            "prompt": PROMPT, "maxNewTokens": N, "stream": True,
            "timeoutSeconds": 60}, out), daemon=True)
        th.start()
        deadline = time.time() + 30
        while not any(r.engine.active for r in reps):
            assert time.time() < deadline
            time.sleep(0.01)
        victim = next(r for r in reps if r.engine.active)
        while len(victim.engine.result(0).tokens) < 9:
            victim.step()
        time.sleep(0.1)
        assert call(victim.url, "/v1/admin/eject", {})[1]["ejected"] == 1
        while th.is_alive():
            assert time.time() < deadline
            for r in reps:
                if r.engine.active:
                    r.step()
            time.sleep(0.005)
        toks = [t for x in out["lines"] if "status" not in x
                and "finishReason" not in x for t in x.get("tokens", [])]
        assert toks == want and router.migrations_total == 1
        # A blocking request through the router: its replica root sits
        # under the attempt that carried it.
        for r in reps:
            r.svc._stop.clear()
            r.svc._thread = threading.Thread(target=r.svc._loop,
                                             daemon=True)
            r.svc._thread.start()
        blocking = router.generate({"prompt": PROMPT[:6],
                                    "maxNewTokens": 5})
        assert blocking["status"] == "ok"
    finally:
        reg.stop()
    spans = [s for p in paths.values() for s in jtr.read_spans(p)]
    roots = [s for s in spans if s["name"] == jflight.ROOT_SPAN_ROUTER]
    assert len(roots) == 2
    by_id = {s["spanId"]: s for s in spans}
    for root in roots:
        tree = [s for s in spans if s["traceId"] == root["traceId"]]
        reps_roots = sorted((s for s in tree
                             if s["name"] == jflight.ROOT_SPAN_REPLICA),
                            key=lambda s: s["startTimeUnixNano"])
        parents = [by_id[s["parentSpanId"]] for s in reps_roots]
        assert all(p["parentSpanId"] == root["spanId"] for p in parents)
        for rep_root in reps_roots:
            kids = {s["name"] for s in tree
                    if s["parentSpanId"] == rep_root["spanId"]}
            assert {"admission", "queue_wait", "prefill", "decode"} <= kids
        if len(reps_roots) == 2:              # the migrated stream
            assert [p["name"] for p in parents] == ["router.hop"] * 2
            assert reps_roots[0]["attributes"]["migrate.reason"] == "eject"
            assert reps_roots[1]["attributes"]["resume.committed"] >= 9
            assert any(s["name"] == "eject" for s in tree)
            assert any(s["name"] == "resume" for s in tree)
        else:
            assert [p["name"] for p in parents] == ["router.attempt"]


# ------------------------------------------------------------- telemetry

@pytest.fixture
def optimizer():
    svc = OptimizerService()
    server = ThreadingHTTPServer(("127.0.0.1", 0), jopt_main.make_handler(
        svc, auth_token="s3cret"))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield svc, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    th.join(10)


def test_push_teaches_the_jax_optimizer(optimizer):
    svc, url = optimizer
    client = HTTPOptimizerClient(url, auth_token="s3cret")
    metrics = {"tokens": 384, "aggregate_tokens_per_s": 52.5,
               "token_lat_p99_ms": 12.8}
    assert serve.push_serving_telemetry(metrics, client, "bucket-x",
                                        tenants=4, slots=8)
    pred = svc.predict_time_slice({"bucket": "bucket-x",
                                   "target_p99_ms": 13.0})
    assert pred["status"] == "ok" and pred["prediction"]["max_tenants"] == 4
    bad = HTTPOptimizerClient(url, auth_token="wrong")
    assert not serve.push_serving_telemetry(metrics, bad, "b2", 1, 8)
    assert not serve.push_serving_telemetry(
        {"tokens": 0, "token_lat_p99_ms": 0}, client, "b", 1, 8)
    dead = HTTPOptimizerClient("http://127.0.0.1:1")
    assert not serve.push_serving_telemetry(metrics, dead, "b", 1, 8)
    assert dead.push_failures == 1
    args = serve.build_parser().parse_args(ARGS + ["--int8"])
    assert serve.telemetry_bucket(args) == "d64-L2-ff128-V128|int8"


def test_serve_main_pushes_with_its_bearer_token(optimizer, tmp_path):
    svc, url = optimizer
    port, stop, th, result = _run_main(ARGS + [
        "--optimizer-url", url, "--telemetry-interval", "1",
        "--tenants", "2", "--auth-token", "s3cret"])
    base = f"http://127.0.0.1:{port}"
    try:
        req = urllib.request.Request(
            base + "/v1/generate", data=json.dumps(
                {"prompt": PROMPT, "maxNewTokens": 20}).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": "Bearer s3cret"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        bucket = "d64-L2-ff128-V128|bf16"
        deadline = time.time() + 20
        while svc.predict_time_slice({"bucket": bucket, "target_p99_ms":
                                      1e6})["status"] != "ok":
            assert time.time() < deadline, "no telemetry push landed"
            time.sleep(0.2)
    finally:
        stop.set()
        th.join(30)
    assert result.get("rc") == 0
