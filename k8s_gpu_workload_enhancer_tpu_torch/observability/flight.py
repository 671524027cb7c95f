"""Request flight recorder: the replica half of end-to-end tracing.

The port's own copy of the JAX package's observability/flight.py, with the
same span names, the same tree and the same metrics arithmetic, so a torch
replica's span tree nests under the fleet router's ``router.attempt`` span
exactly as a JAX replica's does. The fleet router opens a root span per
admission and injects its context on the upstream hop; the replica's
``FlightRecorder`` turns every terminal request view into a span tree that
adopts that remote parent:

- root ``replica.generate``, one per request on this replica: request id,
  tenant and priority, status and finish reason, tokens, the resume carry,
  and the eject family (handoff / preempt / eject / evacuate) and resume as
  zero-duration child spans at their timestamps;
- phase children ``admission`` (HTTP arrival -> engine enqueue),
  ``queue_wait`` (enqueue -> slot admission), ``prefetch`` (a host-tier
  restore, models/kvhost.py; absent when nothing was restored),
  ``prefill`` (admission -> first token, the prefill chunks as events),
  ``decode`` (first token -> terminal, decode-step and commit events);
- a ``first_token`` event on the root, and its ``ttft_ms``.

Everything is built after the fact, at terminal-view time, from the
engine's timestamps (ServeRequest.submitted_at / admitted_at /
first_token_at / done_at, on the perf_counter clock) and the
``phase_events`` the engine appends when ``record_phase_events`` is on.
The decode path runs no tracing code. The ``ktwe_serving_phase_seconds_*``
windows are fed here, from the same subtractions the spans are built
from, so the metrics and the traces cannot disagree.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..utils.stats import LatencyWindow
from ..utils.tracing import Span, _id, parse_traceparent

# Root span names — the SlowRequestCapture ring keys its
# capture decision on these (a root ending closes its trace's tree).
ROOT_SPAN_ROUTER = "fleet.generate"
ROOT_SPAN_REPLICA = "replica.generate"
ROOT_SPAN_FRONTDOOR = "frontdoor.route"

# Phase span names (the replica-side request timeline), as the JAX
# serve and the fleet's fakes name them.
PHASE_ADMISSION = "admission"
PHASE_QUEUE_WAIT = "queue_wait"
# Host-tier prefetch: offloaded prefix blocks restoring host -> device
# between queue pop and prefill dispatch. It reads the request's
# prefetch_started_at / prefetch_done_at, which only the host KV tier sets
# (models/kvhost.py); without a restore the span is absent.
PHASE_PREFETCH = "prefetch"
PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"

# Zero-duration marker spans for the eject family + resume splice-in.
MARK_SPANS = ("handoff", "preempt", "eject", "evacuate", "resume")

EVENT_FIRST_TOKEN = "first_token"
EVENT_PREFILL_CHUNK = "prefill_chunk"
EVENT_DECODE_STEP = "decode_step"
EVENT_SPEC_ROUND = "spec_round"
EVENT_COMMIT = "commit"

# Engine phase-event names (models/serving.py appends (t_perf, name,
# value) tuples when record_phase_events is on; values are scalars or
# small tuples — no dict allocation near the hot path).
_ENGINE_PREFILL_CHUNK = "prefill_chunk"
_ENGINE_DECODE_STEP = "decode_step"
_ENGINE_SPEC_ROUND = "spec_round"
_ENGINE_EJECT = "eject"
_ENGINE_RESUME = "resume"
# Commit-phase event: (tokens, dur_s, overlapped01). overlapped=1
# means the host bookkeeping ran while the NEXT round was already
# executing on device (the overlapped commit pipeline); 0 means it sat
# on the critical path (overlap off, or the pipeline-drain tail).
# Attributing this honestly is what lets the commit spans distinguish
# "free" host work from host work the device actually waited on.
_ENGINE_COMMIT = "commit"


@dataclass
class FlightContext:
    """Per-request trace identity, fixed at admission: the root span's
    ids (adopted from the router's ``traceparent`` when present, fresh
    otherwise) and the HTTP arrival wall time. Computed once so the
    final view can carry ``traceId`` before the span tree is built."""

    trace_id: str
    span_id: str
    parent_id: str
    t0_wall: float


class FlightRecorder:
    """Builds and exports one request's span tree at terminal-view
    time, and owns the per-phase latency windows derived from the same
    arithmetic. `tracer` supplies the service name and the exporter
    chain (typically SlowRequestCapture -> JsonlExporter)."""

    def __init__(self, tracer, *, capture=None):
        self._tracer = tracer
        self._capture = capture          # SlowRequestCapture or None
        self.queue_wait = LatencyWindow(capacity=512)
        self.prefetch = LatencyWindow(capacity=512)
        self.prefill = LatencyWindow(capacity=512)
        self.decode_per_token = LatencyWindow(capacity=512)
        self.commit = LatencyWindow(capacity=512)
        self.requests_recorded = 0

    # -- admission-time identity --

    def context(self, traceparent: Optional[str],
                t0_wall: float) -> FlightContext:
        remote = parse_traceparent(traceparent)
        return FlightContext(
            trace_id=remote[0] if remote else _id(128),
            span_id=_id(64),
            parent_id=remote[1] if remote else "",
            t0_wall=float(t0_wall))

    # -- terminal-view recording --

    def record(self, req: Any, ctx: FlightContext, *,
               stream: bool = False) -> str:
        """Turn one terminal request view into its span tree and
        export it (children first, root last — the slow-capture ring
        decides when the root ends). Returns the trace id. Never
        raises into the serving path beyond what the exporter already
        swallows; all times convert from the engine's perf_counter
        basis to wall via one calibration pair taken now."""
        off = time.time() - time.perf_counter()

        def wall(t_perf: Optional[float]) -> Optional[float]:
            return None if t_perf is None else t_perf + off

        now = time.time()
        t_submit = wall(getattr(req, "submitted_at", None)) or ctx.t0_wall
        t_admit = wall(getattr(req, "admitted_at", None))
        t_first = wall(getattr(req, "first_token_at", None))
        t_done = wall(getattr(req, "done_at", None)) or now
        emit_from = int(getattr(req, "emit_from", 0) or 0)
        tokens = len(getattr(req, "tokens", []) or [])
        finish = getattr(req, "finish_reason", None)
        status = ("cancelled" if getattr(req, "cancelled", False)
                  else "error" if finish == "error"
                  else "migrate" if finish == "migrated" else "ok")

        root = Span(
            name=ROOT_SPAN_REPLICA, trace_id=ctx.trace_id,
            span_id=ctx.span_id, parent_id=ctx.parent_id,
            start_time=ctx.t0_wall, end_time=t_done,
            attributes={
                "service.name": self._tracer.service_name,
                "request": int(getattr(req, "req_id", -1)),
                "tenant": getattr(req, "tenant", "") or "",
                "priority": getattr(req, "priority", "interactive"),
                "stream": bool(stream),
                "status": status,
                "finish_reason": finish or "",
                "tokens": tokens,
                "preempted": int(getattr(req, "preempted", 0) or 0),
            })
        if status == "error" and getattr(req, "error", None):
            root.status = f"ERROR: {req.error}"
        children: List[Span] = []

        def child(name: str, start: float, end: float,
                  **attrs: Any) -> Span:
            s = Span(name=name, trace_id=ctx.trace_id, span_id=_id(64),
                     parent_id=ctx.span_id, start_time=start,
                     end_time=end, attributes=dict(attrs))
            s.attributes.setdefault("service.name",
                                    self._tracer.service_name)
            children.append(s)
            return s

        # admission: HTTP arrival -> engine enqueue (validation + the
        # submit lock). Tiny by design; visible when it is not.
        child(PHASE_ADMISSION, ctx.t0_wall, t_submit)
        t_pf0 = wall(getattr(req, "prefetch_started_at", None))
        t_pf1 = wall(getattr(req, "prefetch_done_at", None))
        if t_admit is not None:
            # Host-tier prefetch splits the queue_wait -> prefill seam:
            # queue_wait ends where the restore DMA starts, and the
            # prefetch span runs to slot admission (same subtraction
            # arithmetic as every other phase — metrics and spans stay
            # one computation). No prefetch -> the historical shape.
            if t_pf0 is not None and t_submit <= t_pf0 <= t_admit:
                qw = child(PHASE_QUEUE_WAIT, t_submit, t_pf0)
                self.queue_wait.record(qw.duration_ms)
                pf = child(PHASE_PREFETCH, t_pf0, t_admit,
                           dma_end=t_pf1 if t_pf1 is not None else 0.0)
                self.prefetch.record(pf.duration_ms)
            else:
                qw = child(PHASE_QUEUE_WAIT, t_submit, t_admit)
                self.queue_wait.record(qw.duration_ms)
        # Engine phase events, split to their owning phase span.
        events = getattr(req, "phase_events", None) or ()
        prefill_ev, decode_ev, marks = [], [], []
        for t_perf, name, value in events:
            t = t_perf + off
            if name == _ENGINE_PREFILL_CHUNK:
                prefill_ev.append({"name": EVENT_PREFILL_CHUNK,
                                   "time": t,
                                   "attributes": {"offset": value}})
            elif name == _ENGINE_DECODE_STEP:
                decode_ev.append({"name": EVENT_DECODE_STEP, "time": t,
                                  "attributes": {"tokens": value}})
            elif name == _ENGINE_SPEC_ROUND:
                committed, proposed, accepted = value
                decode_ev.append({"name": EVENT_SPEC_ROUND, "time": t,
                                  "attributes": {"tokens": committed,
                                                 "proposed": proposed,
                                                 "accepted": accepted}})
            elif name == _ENGINE_COMMIT:
                committed, dur_s, overlapped = value
                decode_ev.append({"name": EVENT_COMMIT, "time": t,
                                  "attributes": {
                                      "tokens": committed,
                                      "duration_ms": round(
                                          dur_s * 1e3, 3),
                                      "overlapped": int(overlapped)}})
                self.commit.record(dur_s * 1e3)
            elif name == _ENGINE_EJECT and value in MARK_SPANS:
                marks.append((t, value))
            elif name == _ENGINE_RESUME:
                marks.append((t, "resume"))
        if t_admit is not None:
            p_end = t_first if t_first is not None else t_done
            ps = child(PHASE_PREFILL, t_admit, p_end,
                       prompt_tokens=len(getattr(req, "prompt", [])
                                         or []),
                       resume_committed=emit_from)
            ps.events = prefill_ev
            self.prefill.record(ps.duration_ms)
        if t_first is not None:
            root.add_event(EVENT_FIRST_TOKEN).events[-1]["time"] = \
                t_first
            root.set_attribute(
                "ttft_ms", round((t_first - t_submit) * 1e3, 3))
            ds = child(PHASE_DECODE, t_first, t_done,
                       tokens=max(0, tokens - emit_from))
            ds.events = decode_ev
            gen_after_first = max(0, tokens - emit_from - 1)
            if gen_after_first > 0:
                self.decode_per_token.record(
                    ds.duration_ms / gen_after_first)
        for t, name in marks:
            child(name, t, t, committed=tokens)
            if name != "resume":
                root.set_attribute("migrate.reason", name)
        if emit_from:
            root.set_attribute("resume.committed", emit_from)
        exporter = self._tracer.exporter
        for s in children:
            exporter.export(s)
        exporter.export(root)
        self.requests_recorded += 1
        return ctx.trace_id

    # -- metrics / admin surfaces --

    def slow_list(self) -> List[Dict[str, Any]]:
        return self._capture.slow() if self._capture is not None else []

    def metrics(self) -> Dict[str, Any]:
        """The /v1/metrics ``spans`` block — the source every
        ``ktwe_serving_phase_seconds_*`` / ``ktwe_serving_span_*``
        family reads (see zero_metrics for the spans-off shape)."""
        cap = self._capture

        def seconds(win: LatencyWindow) -> Dict[str, float]:
            snap = win.snapshot()
            return {p: round(snap[f"{p}_ms"] / 1e3, 6)
                    for p in ("p50", "p95", "p99")}

        return {
            "enabled": 1,
            "records": int(cap.records_total if cap is not None
                           else self.requests_recorded),
            "dropped": int(cap.dropped_total if cap is not None else 0),
            "slow_captured": int(cap.captured_total
                                 if cap is not None else 0),
            "requests": self.requests_recorded,
            "phase_s": {
                "queue_wait": seconds(self.queue_wait),
                "prefetch": seconds(self.prefetch),
                "prefill": seconds(self.prefill),
                "decode_per_token": seconds(self.decode_per_token),
                "commit": seconds(self.commit),
            },
        }


def zero_metrics() -> Dict[str, Any]:
    """The ``spans`` block when the flight recorder is off — zeros so
    the Prometheus families stay alive on every deployment."""
    zero = {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    return {"enabled": 0, "records": 0, "dropped": 0,
            "slow_captured": 0, "requests": 0,
            "phase_s": {"queue_wait": dict(zero),
                        "prefetch": dict(zero),
                        "prefill": dict(zero),
                        "decode_per_token": dict(zero),
                        "commit": dict(zero)}}
