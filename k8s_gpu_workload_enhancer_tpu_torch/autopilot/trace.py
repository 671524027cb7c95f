"""Traffic trace capture and the trace-record schema.

The port's own copy of the capture half of the JAX package's
autopilot/trace.py: the same record schema (version 1), the same
``POST /v1/admin/trace`` contract and the same file format, so the JAX
package's replay and tuning tools read a torch replica's trace. One NDJSON
line per TERMINAL generation view (completed, errored, timed out, migrated,
rejected):

- ``ts``            arrival wall time (unix seconds), not the completion
                    time: replay schedules arrivals from it
- ``prompt_tokens`` / ``max_new`` / ``output_tokens``  the token lengths
- ``tenant`` / ``priority``  the tenancy identity and class
- ``stream``        true for NDJSON streaming requests
- ``resume`` / ``committed`` / ``hops``  the resume carry
- ``status``        terminal status (ok/error/timeout/migrate/rejected)
- ``ttft_ms``       observed TTFT (informational)
- ``v``             trace schema version

`TraceWriter` is the capture (thread-safe append, start/stop/rotate; a
record never raises), `admin_trace` the route body, `read_trace` /
`write_trace` the file I/O. The storm generator and the replay and tuning
tools stay in the JAX package: they read trace files and run no model.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

TRACE_SCHEMA_VERSION = 1

# Fields replay REQUIRES of every record; everything else is
# informational and survives round-trips untouched.
REQUIRED_FIELDS = ("ts", "prompt_tokens", "max_new")


class TraceWriter:
    """Append-only NDJSON traffic trace with a start/stop/rotate
    surface (the POST /v1/admin/trace contract) behind one short
    lock. Construction never opens the file; the first record (or an
    explicit `start`) does — a serve main started with --trace-out
    but never traced costs nothing. Records carry the caller's arrival
    timestamp; the clock only stamps rotations."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh: Optional[Any] = None
        self._enabled = bool(enabled)
        self.records_total = 0
        self.rotations_total = 0
        self.dropped_total = 0       # write failures (tracing must
        #                              never take down serving)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _open_locked(self) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    def record(self, rec: Dict[str, Any]) -> bool:
        """Append one trace record; returns False when tracing is
        stopped or the write failed (counted, never raised — capture
        must never fail a generation)."""
        if not self._enabled:
            return False
        rec = dict(rec)
        rec.setdefault("v", TRACE_SCHEMA_VERSION)
        line = json.dumps(rec, sort_keys=True)
        try:
            with self._lock:
                if not self._enabled:
                    return False
                self._open_locked()
                self._fh.write(line + "\n")
                self._fh.flush()
                self.records_total += 1
            return True
        except OSError:
            self.dropped_total += 1
            print(f"trace record dropped ({self.path})", file=sys.stderr,
                  flush=True)
            return False

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
        """Close the live file and move it aside as
        ``<path>.<unix>.<n>``; the next record reopens fresh. Returns
        the rotated path (None when there was nothing to rotate)."""
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
            return {"tracing": self._enabled,
                    "records": self.records_total,
                    "path": self.path}

    def close(self) -> None:
        self.stop()


def admin_trace(writer: Optional[TraceWriter],
                request: Dict[str, Any]) -> Dict[str, Any]:
    """The shared POST /v1/admin/trace route body (serve main AND
    router main speak the identical contract): ``{"action": "start" |
    "stop" | "rotate" | "status"}`` -> ``{"status": "ok", "tracing":
    bool, "records": int, "path": str}``. A process started without
    --trace-out answers 400 (ValueError — no writer to drive)."""
    if writer is None:
        raise ValueError("tracing is not configured "
                         "(start with --trace-out PATH)")
    action = str(request.get("action") or "status")
    if action == "start":
        writer.start()
    elif action == "stop":
        writer.stop()
    elif action == "rotate":
        writer.rotate()
    elif action != "status":
        raise ValueError(f"unknown trace action {action!r} "
                         f"(start | stop | rotate | status)")
    out: Dict[str, Any] = {"status": "ok"}
    out.update(writer.status())
    return out


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Load an NDJSON trace, sorted by arrival ``ts``. Records missing
    a required field fail loudly — a silently skipped record is a
    storm the tuner never saw."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            missing = [k for k in REQUIRED_FIELDS if k not in rec]
            if missing:
                raise ValueError(
                    f"{path}:{i}: trace record missing required "
                    f"field(s) {missing} (schema v"
                    f"{TRACE_SCHEMA_VERSION}: docs/api-reference.md)")
            out.append(rec)
    out.sort(key=lambda r: (float(r["ts"]), r.get("seq", 0)))
    return out


def write_trace(path: str, records: List[Dict[str, Any]]) -> str:
    """Write records as an NDJSON trace (the round-trip half of
    read_trace)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            rec = dict(rec)
            rec.setdefault("v", TRACE_SCHEMA_VERSION)
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return path
