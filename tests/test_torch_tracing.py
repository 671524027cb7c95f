"""The port's tracing and traffic-trace copies, held to the JAX package.

- `format_traceparent` / `parse_traceparent` on seeded cases, valid and
  malformed, give the JAX answers; a `Tracer` span adopts a remote parent
  as the JAX one does.
- `admin_spans` and `admin_trace` answer every action (start, stop, rotate,
  status, an unknown one, a process without the capture) as the JAX route
  bodies do, 400 messages included; rotation moves the live file aside.
- A `SlowRequestCapture` fed one span sequence keeps the same trees and
  counts as the JAX one fed the same sequence.
- The files cross over: the JAX `read_spans`, `read_trace` and
  `scripts/spans_to_perfetto.py` read the port's files, the port's
  `read_trace` reads a JAX-written trace; a record that cannot be written is
  dropped and counted, never raised, in both.
- The optimizer client: the same backoff and never-raise answers.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from k8s_gpu_workload_enhancer_tpu.agent import optimizer_client as jopt
from k8s_gpu_workload_enhancer_tpu.autopilot import trace as jtrace
from k8s_gpu_workload_enhancer_tpu.utils import tracing as jtr
from k8s_gpu_workload_enhancer_tpu_torch.agent import optimizer_client as topt
from k8s_gpu_workload_enhancer_tpu_torch.autopilot import trace as ttrace
from k8s_gpu_workload_enhancer_tpu_torch.utils import tracing as ttr

import torch_parity  # noqa: F401  (one intra-op thread a process)

REPO = Path(__file__).resolve().parents[1]


def _traceparents(seed: int, n: int = 64) -> list:
    """Seeded headers: valid ones, and each way a header can be
    malformed (short ids, non-hex, zero ids, too few parts, not a str)."""
    rng = np.random.default_rng(seed)

    def hexs(k):
        return "".join(rng.choice(list("0123456789abcdef"), k))
    out = [None, "", 7, "00", "00-abc", "00-" + "0" * 32 + "-" + "1" * 16
           + "-01", "00-" + "1" * 32 + "-" + "0" * 16 + "-01"]
    for i in range(n):
        kind = i % 5
        tid, sid = hexs(32), hexs(16)
        if kind == 1:
            tid = tid[:31]
        elif kind == 2:
            sid = "zz" + sid[2:]
        elif kind == 3:
            out.append(f"00-{tid}-{sid}")
            continue
        out.append(f"  00-{tid}-{sid}-01 " if kind == 4
                   else f"00-{tid}-{sid}-01")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traceparent_parse_and_format_match_jax(seed):
    for header in _traceparents(seed):
        assert ttr.parse_traceparent(header) == \
            jtr.parse_traceparent(header), header
    span = ttr.Span(name="x", trace_id="a" * 32, span_id="b" * 16)
    jspan = jtr.Span(name="x", trace_id="a" * 32, span_id="b" * 16)
    assert ttr.format_traceparent(span) == jtr.format_traceparent(jspan)
    assert jtr.parse_traceparent(ttr.format_traceparent(span)) == \
        ("a" * 32, "b" * 16)


def test_tracer_adopts_a_remote_parent_as_jax_does():
    header = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    got = {}
    for name, mod in (("port", ttr), ("jax", jtr)):
        exp = mod.InMemoryExporter()
        tracer = mod.Tracer("svc", exp)
        with tracer.span("root", remote_parent=header, k=1):
            with tracer.span("child"):
                pass
        with tracer.span("fresh", remote_parent="garbage"):
            pass
        spans = [s.to_dict() for s in exp.spans()]
        root = next(s for s in spans if s["name"] == "root")
        got[name] = [(s["name"], s["traceId"] == root["traceId"],
                      s["parentSpanId"] == root["spanId"],
                      s["parentSpanId"], s["attributes"], s["status"])
                     for s in spans if s["name"] != "fresh"]
        fresh = next(s for s in spans if s["name"] == "fresh")
        assert fresh["parentSpanId"] == "" and len(fresh["traceId"]) == 32
        assert root["traceId"] == header.split("-")[1]
        for s in spans:
            s["spanId"] = s["parentSpanId"] = s["traceId"] = "x"
            s["startTimeUnixNano"] = s["endTimeUnixNano"] = 0
    assert got["port"][1][3] == "b7ad6b7169203331"
    for a, b in zip(got["port"], got["jax"]):
        assert a[:3] == b[:3] and a[4:] == b[4:]


def _drive(admin, capture, actions, path, write):
    """Each action's answer (the path masked) or its ValueError message,
    writing one record between actions."""
    out = []
    for action in actions:
        write()
        try:
            ans = admin(capture, {} if action is None
                        else {"action": action})
            ans = dict(ans, path=os.path.basename(ans["path"]))
        except ValueError as e:
            ans = f"400 {e}"
        out.append((action, ans, sorted(
            p.name.split(".")[0] + "." + p.name.split(".")[1]
            for p in Path(path).parent.iterdir())))
    return out


ACTIONS = [None, "status", "stop", "status", "start", "rotate", "status",
           "bogus", "rotate", "stop", "rotate"]


def test_admin_spans_answers_every_action_as_jax(tmp_path):
    got = {}
    for name, mod in (("port", ttr), ("jax", jtr)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "spans.ndjson")
        exp = mod.JsonlExporter(path)
        span = mod.Span(name="s", trace_id="1" * 32, span_id="2" * 16,
                        start_time=1.0, end_time=2.0)
        got[name] = _drive(mod.admin_spans, exp, ACTIONS, path,
                           lambda: exp.export(span))
        with pytest.raises(ValueError) as e:
            mod.admin_spans(None, {"action": "status"})
        got[name].append(str(e.value))
        exp.close()
    assert got["port"] == got["jax"]
    assert "span capture is not configured" in got["port"][-1]


def test_admin_trace_answers_every_action_as_jax(tmp_path):
    got = {}
    for name, mod in (("port", ttrace), ("jax", jtrace)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / "trace.ndjson")
        w = mod.TraceWriter(path)
        rec = {"kind": "generation", "ts": 1.5, "prompt_tokens": 3,
               "max_new": 4}
        got[name] = _drive(mod.admin_trace, w, ACTIONS, path,
                           lambda: w.record(rec))
        with pytest.raises(ValueError) as e:
            mod.admin_trace(None, {})
        got[name].append(str(e.value))
        got[name].append((w.records_total, w.rotations_total,
                          w.dropped_total))
        w.close()
    assert got["port"] == got["jax"]
    assert "tracing is not configured" in got["port"][-2]


def _span_sequence(mod, seed: int):
    """Spans of 6 traces, children then root, the roots' durations spread
    around the threshold, and a late straggler of a closed trace."""
    rng = np.random.default_rng(seed)
    spans = []
    for t in range(6):
        tid = f"{t + 1:032x}"
        start = 100.0 + t
        dur = float(rng.choice([0.05, 0.2, 0.5]))
        for c in range(int(rng.integers(1, 4))):
            spans.append(mod.Span(name=f"phase{c}", trace_id=tid,
                                  span_id=f"{t * 10 + c + 1:016x}",
                                  parent_id=f"{t + 1:016x}",
                                  start_time=start, end_time=start + 0.01))
        spans.append(mod.Span(name="replica.generate", trace_id=tid,
                              span_id=f"{t + 1:016x}", start_time=start,
                              end_time=start + dur,
                              attributes={"request": t}))
    spans.append(mod.Span(name="late", trace_id=f"{1:032x}",
                          span_id="f" * 16, start_time=1.0, end_time=2.0))
    return spans


@pytest.mark.parametrize("threshold", [0.0, 0.1, 0.3])
def test_slow_request_capture_matches_jax(threshold):
    got = {}
    for name, mod in (("port", ttr), ("jax", jtr)):
        inner = mod.InMemoryExporter()
        cap = mod.SlowRequestCapture(inner, threshold_s=threshold,
                                     root_names=("replica.generate",),
                                     capacity=3)
        for s in _span_sequence(mod, 5):
            cap.export(s)
        got[name] = (cap.slow(), cap.records_total, cap.captured_total,
                     cap.dropped_total, len(inner.spans()))
    assert got["port"] == got["jax"]
    if threshold == 0.1:
        assert got["port"][2] > 0 and got["port"][0]


def test_files_cross_between_the_packages(tmp_path):
    """The JAX readers read the port's span and trace files; the port's
    read_trace reads a JAX trace; a failing write is counted, not raised."""
    spans_path = str(tmp_path / "spans.ndjson")
    exp = ttr.JsonlExporter(spans_path)
    tracer = ttr.Tracer("ktwe-serve", exp)
    with tracer.span("replica.generate", request=3) as root:
        root.add_event("first_token")
        with tracer.span("decode"):
            pass
    exp.close()
    with open(spans_path, "a") as f:
        f.write('{"torn": ')                 # a torn final line
    assert jtr.read_spans(spans_path) == ttr.read_spans(spans_path)
    names = [s["name"] for s in jtr.read_spans(spans_path)]
    assert names == ["decode", "replica.generate"]
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import spans_to_perfetto
    finally:
        sys.path.pop(0)
    events = spans_to_perfetto.to_trace_events(
        spans_to_perfetto.load_spans([spans_path]),
        trace_id=root.trace_id)
    assert {e["name"] for e in events if e["ph"] == "X"} == {
        "decode", "replica.generate"}
    recs = [{"kind": "generation", "ts": 3.0 - i, "seq": i,
             "prompt_tokens": 5, "max_new": 4, "status": "ok"}
            for i in range(3)]
    tpath, jpath = str(tmp_path / "t.ndjson"), str(tmp_path / "j.ndjson")
    w = ttrace.TraceWriter(tpath)
    for r in recs:
        assert w.record(r)
    w.close()
    jtrace.write_trace(jpath, recs)
    assert Path(tpath).read_text() == Path(jpath).read_text()
    assert jtrace.read_trace(tpath) == ttrace.read_trace(jpath) == \
        jtrace.read_trace(jpath)
    ttrace.write_trace(tpath, recs[:1] + [{"ts": 1.0}])
    for mod in (ttrace, jtrace):
        with pytest.raises(ValueError, match="missing required field"):
            mod.read_trace(tpath)
    blocked = tmp_path / "file"
    blocked.write_text("")
    for mod in (ttrace, jtrace):
        bad = mod.TraceWriter(str(blocked / "sub" / "t.ndjson"))
        assert bad.record(recs[0]) is False
        assert (bad.records_total, bad.dropped_total) == (0, 1)


def test_optimizer_client_never_raises_and_backs_off():
    """A dead optimizer: the first push fails (counted), the next is
    skipped inside the cooldown, with the JAX client's answers."""
    got = {}
    for name, mod in (("port", topt), ("jax", jopt)):
        c = mod.HTTPOptimizerClient("http://127.0.0.1:1", auth_token="t",
                                    timeout_s=2.0, cooldown_s=60.0)
        first = c.ingest_serving_telemetry({"bucket": "b"})
        second = c.ingest_serving_telemetry({"bucket": "b"})
        got[name] = (first["status"], second, c.push_failures,
                     c.pushes_skipped)
    assert got["port"] == got["jax"]
    assert got["port"][:1] == ("error",) and got["port"][2:] == (1, 1)
    assert json.dumps(got["port"][1]) == json.dumps(
        {"status": "error", "error": "optimizer in backoff"})
