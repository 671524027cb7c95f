"""The node's chip families in the Prometheus text format, in the role of
the JAX package's monitoring/exporter.py, read from a `GPUClient`.

The families have the JAX exporter's names, types and label sets:

  ktwe_chip_duty_cycle_percent{node, chip}            gauge
  ktwe_chip_tensorcore_utilization_percent{node, chip} gauge
  ktwe_chip_hbm_used_gb{node, chip}                    gauge
  ktwe_chip_hbm_total_gb{node, chip}                   gauge
  ktwe_chip_power_watts{node, chip}                    gauge
  ktwe_chip_temperature_celsius{node, chip}            gauge
  ktwe_chip_healthy{node, chip}                        gauge (1 / 0)
  ktwe_cluster_chips_total{state}                      gauge

On NVML the duty cycle is `utilization.gpu`, HBM the card's memory, and
the tensor-core share 0 (the libtpu reader sends none either). A series,
once collected, keeps its last value, as a prometheus_client gauge does.
The text is rendered here from the standard library (the card's machine
has no prometheus_client). The same collect loop (first pass after one
interval) and the same `/metrics` and `/health` server as the JAX one.

The scheduler, topology, sub-slice, cost and component-error groups stay
with the JAX exporter, which runs in the control plane's process beside
the scheduler, the sub-slice controller and the cost engine that feed
them (utils/procmetrics.py likewise leaves out the error family).
"""

from __future__ import annotations

import math
import sys
import threading
import traceback
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from ..discovery.client import GPUClient
from ..discovery.types import ChipHealth

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
PREFIX = "ktwe_"

_CHIP = ("node", "chip")
# (suffix, help, label names), in the JAX exporter's order; the seven chip
# gauges first.
FAMILIES = (
    ("chip_duty_cycle_percent",
     "Share of the last sample period in which a kernel ran", _CHIP),
    ("chip_tensorcore_utilization_percent",
     "Tensor-core share while busy (0: not read)", _CHIP),
    ("chip_hbm_used_gb", "Device memory in use", _CHIP),
    ("chip_hbm_total_gb", "Device memory capacity", _CHIP),
    ("chip_power_watts", "Chip power draw", _CHIP),
    ("chip_temperature_celsius", "Chip temperature", _CHIP),
    ("chip_healthy", "1 healthy / 0 not", _CHIP),
    ("cluster_chips_total", "Chips known to the node's client", ("state",)),
)


@dataclass
class ExporterConfig:
    port: int = 9400
    collect_interval_s: float = 15.0


def _value(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _label(v: str) -> str:
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


class ChipExporter:
    def __init__(self, client: GPUClient,
                 config: Optional[ExporterConfig] = None):
        self._client = client
        self._cfg = config or ExporterConfig()
        self._lock = threading.Lock()
        # family suffix -> {label values: value}
        self._series: Dict[str, Dict[Tuple[str, ...], float]] = {
            name: {} for name, _, _ in FAMILIES}
        self._stop = threading.Event()
        self._threads: list = []
        self._server: Optional[ThreadingHTTPServer] = None

    def start(self) -> None:
        self._stop.clear()
        t = threading.Thread(target=self._collect_loop, daemon=True,
                             name="ktwe-exporter-collect")
        t.start()
        self._threads.append(t)
        self._server = ThreadingHTTPServer(
            ("0.0.0.0", self._cfg.port), self._handler_class())
        st = threading.Thread(target=self._server.serve_forever,
                              daemon=True, name="ktwe-exporter-http")
        st.start()
        self._threads.append(st)

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.server_address[1]
        return self._cfg.port

    def collect_once(self) -> None:
        rows = {}
        healthy = unhealthy = 0
        for node in self._client.list_node_names():
            utils = self._client.get_utilization(node)
            health = self._client.get_health(node)
            for chip_id, u in utils.items():
                ok = health.get(chip_id, ChipHealth()).schedulable
                values = (u.duty_cycle_pct, u.tensorcore_util_pct,
                          u.hbm_used_gb, u.hbm_total_gb, u.power_watts,
                          u.temperature_c, 1 if ok else 0)
                for (name, _, _), v in zip(FAMILIES, values):
                    rows.setdefault(name, {})[(node, chip_id)] = float(v)
                healthy += 1 if ok else 0
                unhealthy += 0 if ok else 1
        rows["cluster_chips_total"] = {("healthy",): float(healthy),
                                       ("unhealthy",): float(unhealthy)}
        with self._lock:
            for name, series in rows.items():
                self._series[name].update(series)

    def _collect_loop(self) -> None:
        while not self._stop.wait(self._cfg.collect_interval_s):
            try:
                self.collect_once()
            except Exception:   # the loop must survive, but never silently
                print(f"ktwe-exporter: collect failed\n"
                      f"{traceback.format_exc()}", file=sys.stderr,
                      flush=True)

    def render(self) -> bytes:
        out = []
        with self._lock:
            for name, help_text, labels in FAMILIES:
                full = PREFIX + name
                out.append(f"# HELP {full} {help_text}")
                out.append(f"# TYPE {full} gauge")
                for key, v in self._series[name].items():
                    lab = ",".join(f'{k}="{_label(x)}"'
                                   for k, x in zip(labels, key))
                    out.append(f"{full}{{{lab}}} {_value(v)}")
        return ("\n".join(out) + "\n").encode()

    def _handler_class(self):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:
                if self.path == "/metrics":
                    body, ctype = exporter.render(), CONTENT_TYPE
                elif self.path == "/health":
                    body, ctype = b'{"status":"ok"}', "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a: object) -> None:   # quiet
                pass

        return Handler
