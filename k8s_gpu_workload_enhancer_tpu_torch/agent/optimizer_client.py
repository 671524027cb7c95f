"""HTTP client of the optimizer service (the JAX package's cmd/optimizer.py,
`:50051`): the port's own copy of the JAX package's
agent/optimizer_client.py, with the same routes, bearer token, backoff and
answers.

The node agent (`cmd/agent.py --optimizer-url`) pushes its per-workload
points through `ingest_telemetry` to POST /v1/telemetry, the surface an
in-process `OptimizerService` has, so the agent does not know its
transport. The serve main's telemetry thread (`--optimizer-url`) pushes
its density points through `ingest_serving_telemetry` to POST
/v1/serving-telemetry, which teaches the optimizer's ServingPredictor.
Failures are returned, not raised: a down optimizer must not take down
serving or node telemetry. After a failure the client backs off for
`cooldown_s`, so a blackholed optimizer costs one timeout a window, not
one a push.
"""

from __future__ import annotations

import http.client
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict


class HTTPOptimizerClient:
    def __init__(self, base_url: str, auth_token: str = "",
                 timeout_s: float = 5.0, cooldown_s: float = 30.0):
        self._base = base_url.rstrip("/")
        self._token = auth_token
        self._timeout = timeout_s
        self._cooldown = cooldown_s
        self._backoff_until = 0.0
        self.push_failures = 0
        self.pushes_skipped = 0

    def ingest_telemetry(self, point: Dict[str, Any]) -> Dict[str, Any]:
        """A node agent's per-workload point, for the optimizer's learning
        loop."""
        return self._post("/v1/telemetry", point)

    def ingest_serving_telemetry(self, point: Dict[str, Any]
                                 ) -> Dict[str, Any]:
        """A serving tenant's density point (cmd/serve.py
        --optimizer-url), for the ServingPredictor's admission model."""
        return self._post("/v1/serving-telemetry", point)

    def _post(self, path: str, point: Dict[str, Any]) -> Dict[str, Any]:
        if time.time() < self._backoff_until:
            self.pushes_skipped += 1
            return {"status": "error", "error": "optimizer in backoff"}
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        req = urllib.request.Request(
            self._base + path,
            data=json.dumps(point).encode(), headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, http.client.HTTPException,
                OSError, ValueError) as e:
            self.push_failures += 1
            self._backoff_until = time.time() + self._cooldown
            print(f"optimizer push to {self._base} failed (backing off "
                  f"{self._cooldown}s): {str(e)[:120]}", file=sys.stderr,
                  flush=True)
            return {"status": "error", "error": str(e)}
