"""The per-node telemetry agent: the port's copy of the JAX package's
agent/agent.py (`AgentConfig`, `ChipAssignment`, `NodeAgent`,
`AgentServer`), on a GPU node's device layer (`GPUClient`).

On a short cadence (default 5 s) the agent reads its chips' counters,
averages them a workload over the chips the controller assigned it, and
pushes one telemetry point a workload to the optimizer
(`ingest_telemetry`: the JAX `OptimizerService`, or
`HTTPOptimizerClient` to the JAX optimizer main), the same summary and the
same point keys as the JAX agent. The cost engine's usage update and the
discovery service's per-node refresh stay optional hooks (`cost_engine=`,
`discovery=`): both services are the JAX control plane's.

`AgentServer` serves the JAX agent's routes, behind the same bearer
token (utils/httpjson.py):

  GET  /health        -> liveness, the device source, last-telemetry age
  GET  /v1/telemetry  -> the latest per-workload summary
  POST /v1/assign     {"workloadUid": ..., "chipIds": [...]}
  POST /v1/release    {"chipIds": [...]}
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..discovery.client import GPUClient


@dataclass
class AgentConfig:
    node_name: str = ""
    telemetry_interval_s: float = 5.0
    # The device-counter source (nvml / file:<path> / fake), shown on
    # /health so an operator sees whether a node reads its card.
    shim_source: str = ""


@dataclass
class ChipAssignment:
    """Which workload owns a chip (set by the controller when pods bind)."""

    chip_id: str
    workload_uid: str


class NodeAgent:
    def __init__(self, gpu_client: GPUClient, config: AgentConfig,
                 optimizer_service=None, cost_engine=None,
                 discovery=None):
        self._gpu = gpu_client
        self._cfg = config
        self._optimizer = optimizer_service
        self._cost = cost_engine
        self._discovery = discovery
        self._lock = threading.RLock()
        self._assignments: Dict[str, str] = {}     # chip_id -> workload uid
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_pushed = 0
        self._last_summary: Dict[str, Dict[str, float]] = {}
        self._last_summary_ts = 0.0

    def assign_chips(self, workload_uid: str, chip_ids: List[str]) -> None:
        with self._lock:
            for cid in chip_ids:
                self._assignments[cid] = workload_uid

    def release_chips(self, chip_ids: List[str]) -> None:
        with self._lock:
            for cid in chip_ids:
                self._assignments.pop(cid, None)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"ktwe-agent-{self._cfg.node_name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self._cfg.telemetry_interval_s):
            try:
                summary = self.collect_and_push()
                with self._lock:
                    self._last_summary = summary
                    self._last_summary_ts = time.time()
            except Exception:   # the loop must survive, but never silently
                print(f"ktwe-agent {self._cfg.node_name}: telemetry push "
                      f"failed\n{traceback.format_exc()}", file=sys.stderr,
                      flush=True)

    def collect_and_push(self) -> Dict[str, Dict[str, float]]:
        node = self._cfg.node_name
        utils = self._gpu.get_utilization(node)
        per_workload: Dict[str, List] = {}
        with self._lock:
            assignments = dict(self._assignments)
        for chip_id, u in utils.items():
            uid = assignments.get(chip_id)
            if uid is not None:
                per_workload.setdefault(uid, []).append(u)
        summary: Dict[str, Dict[str, float]] = {}
        now = time.time()
        for uid, chips in per_workload.items():
            duty = sum(c.duty_cycle_pct for c in chips) / len(chips)
            hbm_pct = sum(
                100.0 * c.hbm_used_gb / c.hbm_total_gb if c.hbm_total_gb else 0
                for c in chips) / len(chips)
            summary[uid] = {"duty_cycle_pct": duty, "hbm_used_pct": hbm_pct}
            if self._optimizer is not None:
                self._optimizer.ingest_telemetry({
                    "workload_id": uid,
                    "timestamp": now,
                    "duty_cycle_pct": duty,
                    "hbm_used_pct": hbm_pct,
                    "chips": len(chips),
                })
            if self._cost is not None:
                self._cost.update_usage_metrics(uid, duty, hbm_pct)
            self.samples_pushed += 1
        if self._discovery is not None:
            self._discovery.refresh_utilization()
        return summary


class AgentServer:
    """The agent's HTTP surface (the routes in the module note)."""

    def __init__(self, agent: NodeAgent):
        self._agent = agent
        self._server = None
        self._thread: Optional[threading.Thread] = None

    def start(self, port: int = 50052, auth_token: str = "") -> None:
        from http.server import ThreadingHTTPServer
        from ..utils.httpjson import make_json_handler

        agent = self._agent

        # Routes snapshot shared state under the lock and return plain
        # data; the handler writes to the socket outside it.
        def health(_req):
            with agent._lock:
                age = (time.time() - agent._last_summary_ts
                       if agent._last_summary_ts else None)
            return {"status": "ok", "node": agent._cfg.node_name,
                    "shim_source": agent._cfg.shim_source or "fake",
                    "last_telemetry_age_s": age}

        def telemetry(_req):
            with agent._lock:
                return {"node": agent._cfg.node_name,
                        "timestamp": agent._last_summary_ts,
                        "workloads": dict(agent._last_summary)}

        def assign(req):
            agent.assign_chips(req["workloadUid"], list(req["chipIds"]))
            return {"status": "ok"}

        def release(req):
            agent.release_chips(list(req["chipIds"]))
            return {"status": "ok"}

        handler = make_json_handler(
            {"/v1/assign": assign, "/v1/release": release},
            get_routes={"/health": health, "/v1/telemetry": telemetry},
            auth_token=auth_token)
        self._server = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="ktwe-agent-http")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
