"""Distributed tracing: the span half of the request flight recorder.

The port's own copy of the parts of the JAX package's utils/tracing.py that
the serve main uses, with the same names, the same OTLP-shaped span NDJSON
and the same admin contract (its answers and its 400 messages), so a torch
replica's span file reads with the JAX `read_spans` and joins the fleet
router's trace:

- `format_traceparent` / `parse_traceparent`: the W3C trace-context header
  the fleet router injects on the proxy hop;
- `Span`, `Tracer` (thread-local context, an inbound `traceparent` adopted
  as the remote parent) and `InMemoryExporter`;
- `JsonlExporter` (`--span-out`): one open file handle for its life, a
  flush a span, never a raise into the caller (failures count in
  ``dropped_total``), start/stop/rotate behind `admin_spans`, the
  ``POST /v1/admin/spans`` body; `read_spans` loads a file;
- `SlowRequestCapture`: the slow-request ring behind
  ``GET /v1/admin/slow-requests``. When a root span (``root_names``) ends
  over ``threshold_s`` its whole buffered tree is kept.

The serving stack's per-phase span tree is built by observability/flight.py.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _id(bits: int) -> str:
    return f"{random.getrandbits(bits):0{bits // 4}x}"


def format_traceparent(span: "Span") -> str:
    """W3C trace-context header for a live span: what the fleet router
    injects on the proxy hop so one trace covers router -> replica."""
    return f"00-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[tuple]:
    """(trace_id, parent_span_id) from a ``traceparent`` header, or None
    for anything malformed: a bad header degrades to a fresh root trace,
    never to a 400 or a crash in the serving path."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    _version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id, span_id


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    start_time: float = field(default_factory=time.time)
    end_time: float = 0.0
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "OK"
    _tracer: Optional["Tracer"] = None

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs) -> "Span":
        self.events.append({"name": name, "time": time.time(),
                            "attributes": attrs})
        return self

    def set_status(self, status: str) -> "Span":
        self.status = status
        return self

    def end(self) -> None:
        if self.end_time:
            return
        self.end_time = time.time()
        if self._tracer is not None:
            self._tracer._finish(self)

    @property
    def duration_ms(self) -> float:
        end = self.end_time or time.time()
        return (end - self.start_time) * 1000.0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "traceId": self.trace_id,
                "spanId": self.span_id, "parentSpanId": self.parent_id,
                "startTimeUnixNano": int(self.start_time * 1e9),
                "endTimeUnixNano": int(self.end_time * 1e9),
                "attributes": self.attributes, "events": self.events,
                "status": self.status}


class InMemoryExporter:
    """The last `capacity` finished spans (a bounded deque: O(1)
    eviction)."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=int(capacity))

    def export(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            return [s for s in self._spans
                    if name is None or s.name == name]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


class JsonlExporter:
    """OTLP-shaped span NDJSON (``--span-out``). One open file handle for
    the exporter's whole life (flushed a span, so a collector tail reads
    lines as they land), never a raise into the caller: tracing must not
    fail the traffic it observes. The start/stop/rotate surface mirrors
    autopilot/trace.TraceWriter, so ``POST /v1/admin/spans`` and
    ``POST /v1/admin/trace`` drive the two captures with one contract."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh: Optional[Any] = None
        self._enabled = bool(enabled)
        self.records_total = 0
        self.dropped_total = 0          # write failures, counted not raised
        self.rotations_total = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _open_locked(self) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")

    def export(self, span: Span) -> None:
        if not self._enabled:
            return
        try:
            line = json.dumps(span.to_dict())
            with self._lock:
                if not self._enabled:
                    return
                self._open_locked()
                self._fh.write(line + "\n")
                self._fh.flush()
                self.records_total += 1
        except (OSError, TypeError, ValueError):
            self.dropped_total += 1

    def start(self) -> None:
        with self._lock:
            self._enabled = True

    def stop(self) -> None:
        with self._lock:
            self._enabled = False
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def rotate(self) -> Optional[str]:
        """Close the live file and move it aside as ``<path>.<unix>.<n>``;
        the next span reopens a fresh one. Returns the rotated path (None
        when there was nothing to rotate)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if not os.path.exists(self.path):
                return None
            self.rotations_total += 1
            rotated = (f"{self.path}.{int(time.time())}"
                       f".{self.rotations_total}")
            os.replace(self.path, rotated)
        return rotated

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"spans": self._enabled,
                    "records": self.records_total,
                    "dropped": self.dropped_total,
                    "path": self.path}

    def close(self) -> None:
        self.stop()


def admin_spans(exporter: Optional[JsonlExporter],
                request: Dict[str, Any]) -> Dict[str, Any]:
    """The ``POST /v1/admin/spans`` route body (the JAX serve and router
    mains speak the same contract): ``{"action": "start" | "stop" |
    "rotate" | "status"}`` -> ``{"status": "ok", "spans": bool, "records":
    int, "dropped": int, "path": str}``. A process started without
    --span-out answers 400 (ValueError: no span log to drive)."""
    if exporter is None:
        raise ValueError("span capture is not configured "
                         "(start with --span-out PATH)")
    action = str(request.get("action") or "status")
    if action == "start":
        exporter.start()
    elif action == "stop":
        exporter.stop()
    elif action == "rotate":
        exporter.rotate()
    elif action != "status":
        raise ValueError(f"unknown spans action {action!r} "
                         f"(start | stop | rotate | status)")
    out: Dict[str, Any] = {"status": "ok"}
    out.update(exporter.status())
    return out


def read_spans(path: str) -> List[Dict[str, Any]]:
    """A span NDJSON file (``--span-out``) as dicts, a torn final line
    skipped (the process may have died mid-write; every complete line is
    a complete span)."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


class SlowRequestCapture:
    """Exporter wrapper implementing the slow-request ring.

    Finished spans buffer by trace id (a bounded LRU of live traces); when
    a span named in ``root_names`` ends, its whole buffered tree is kept in
    the ring (duration at or over ``threshold_s``) or discarded, so only
    the requests that breach keep their tree resident. ``threshold_s <= 0``
    disables capture; the wrapper still forwards and counts, so the
    metrics stay uniform. Every span forwards to ``inner`` unchanged."""

    def __init__(self, inner: Any, *, threshold_s: float = 0.0,
                 root_names: tuple = (), capacity: int = 32,
                 max_live_traces: int = 256,
                 max_spans_per_trace: int = 512):
        self.inner = inner
        self.threshold_s = float(threshold_s)
        self.root_names = tuple(root_names)
        self._lock = threading.Lock()
        self._live: "collections.OrderedDict[str, List[Span]]" = \
            collections.OrderedDict()
        self._max_live = int(max_live_traces)
        self._max_spans = int(max_spans_per_trace)
        # Traces whose root already closed: a late straggler must not
        # open a bucket no root will ever pop (enough of those would
        # evict live traces' buffers). Bounded like the live set.
        self._closed: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._ring: "collections.deque" = collections.deque(
            maxlen=int(capacity))
        self.records_total = 0
        self.captured_total = 0

    @property
    def dropped_total(self) -> int:
        return int(getattr(self.inner, "dropped_total", 0))

    def export(self, span: Span) -> None:
        with self._lock:
            self.records_total += 1
            if self.threshold_s > 0:
                if (span.trace_id in self._closed
                        and span.name not in self.root_names):
                    if self.inner is not None:
                        self.inner.export(span)
                    return
                bucket = self._live.setdefault(span.trace_id, [])
                if len(bucket) < self._max_spans:
                    bucket.append(span)
                self._live.move_to_end(span.trace_id)
                while len(self._live) > self._max_live:
                    self._live.popitem(last=False)
                if span.name in self.root_names:
                    self._closed[span.trace_id] = None
                    self._closed.move_to_end(span.trace_id)
                    while len(self._closed) > self._max_live:
                        self._closed.popitem(last=False)
                    tree = self._live.pop(span.trace_id, [])
                    dur_s = span.duration_ms / 1e3
                    if dur_s >= self.threshold_s:
                        self.captured_total += 1
                        self._ring.append({
                            "traceId": span.trace_id,
                            "root": span.name,
                            "durationMs": round(span.duration_ms, 3),
                            "attributes": dict(span.attributes),
                            "spans": [s.to_dict() for s in tree],
                        })
        if self.inner is not None:
            self.inner.export(span)

    def slow(self) -> List[Dict[str, Any]]:
        """Captured slow-request trees, most recent last: the
        ``GET /v1/admin/slow-requests`` payload."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._live.clear()
            self._closed.clear()


class Tracer:
    """Thread-local context propagation; child spans nest automatically."""

    def __init__(self, service_name: str = "ktwe",
                 exporter: Optional[Any] = None):
        self.service_name = service_name
        self._exporter = exporter or InMemoryExporter()
        self._local = threading.local()

    @property
    def exporter(self):
        return self._exporter

    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def start_span(self, name: str,
                   attributes: Optional[Dict[str, Any]] = None,
                   remote_parent: Optional[str] = None,
                   parent: Optional[Span] = None) -> Span:
        """A new span, child of `parent` if given, else of this thread's
        innermost live span, else of `remote_parent` (an inbound
        ``traceparent``: the span joins the remote trace; a malformed one
        is ignored), else a fresh root."""
        stack = self._stack()
        if parent is None:
            parent = stack[-1] if stack else None
        remote = None if parent else parse_traceparent(remote_parent)
        span = Span(
            name=name,
            trace_id=(parent.trace_id if parent
                      else remote[0] if remote else _id(128)),
            span_id=_id(64),
            parent_id=(parent.span_id if parent
                       else remote[1] if remote else ""),
            attributes=dict(attributes or {}),
            _tracer=self)
        span.attributes.setdefault("service.name", self.service_name)
        stack.append(span)
        return span

    def _finish(self, span: Span) -> None:
        stack = self._stack()
        if span in stack:
            stack.remove(span)
        self._exporter.export(span)

    @contextlib.contextmanager
    def span(self, name: str, remote_parent: Optional[str] = None,
             **attributes):
        s = self.start_span(name, attributes, remote_parent=remote_parent)
        try:
            yield s
        except Exception as e:
            s.set_status(f"ERROR: {type(e).__name__}: {e}")
            raise
        finally:
            s.end()
