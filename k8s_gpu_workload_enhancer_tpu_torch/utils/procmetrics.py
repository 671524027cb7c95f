"""A per-process /metrics endpoint in the Prometheus text format.

The port's copy of the part of the JAX package's monitoring/procmetrics.py
that a serve main uses: caller-supplied series only (the port has no
structured logger, so the `ktwe_component_errors_total` family of that
module is not served here). Standard library only; a name ending in
`_total` is typed counter, every other gauge.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional


def render_process_metrics(extra: Optional[Dict[str, float]] = None) -> str:
    lines = []
    for name, value in sorted((extra or {}).items()):
        kind = "counter" if name.endswith("_total") else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


class ProcMetricsServer:
    """Tiny /metrics + /health server for a service main."""

    def __init__(self,
                 extra: Optional[Callable[[], Dict[str, float]]] = None):
        self._extra = extra
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int) -> None:
        extra_fn = self._extra

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    body = render_process_metrics(
                        extra_fn() if extra_fn else None).encode()
                    ctype = "text/plain; version=0.0.4"
                elif path == "/health":
                    body = b'{"status": "ok"}'
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a: object) -> None:   # quiet
                pass

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="ktwe-proc-metrics")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
