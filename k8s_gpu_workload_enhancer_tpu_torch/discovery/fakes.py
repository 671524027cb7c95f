"""What the agent main's `--fake-topology` needs: a fabricated node of N
devices, N the product of the shape's sides ("2x4" is 8). It reports what
the JAX package's `FakeTPUClient` reports for the same shape: every chip
idle and healthy, with the capacity that fake gives a chip of its default
generation. Dev mode only; nothing here reads a device.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

from .client import GPUClient
from .types import ChipHealth, ChipUtilization, HealthStatus

# The JAX fake's per-chip capacity (its default generation's), so the two
# agents' dev modes report alike.
FAKE_HBM_TOTAL_GB = 16.0


def shape_chips(topology: str) -> int:
    """Chips of a shape "AxBxC" (one to three sides), as the JAX
    `SliceShape.parse` reads it."""
    sides = [int(p) for p in topology.lower().split("x")]
    if len(sides) > 3:
        raise ValueError(f"bad slice topology {topology!r}")
    return math.prod(sides)


class FakeGPUClient(GPUClient):
    def __init__(self, node_name: str, topology: str = "2x4"):
        self._node_name = node_name
        now = time.time()
        ids = [f"{node_name}-chip-{i}" for i in range(shape_chips(topology))]
        self._util = {c: ChipUtilization(hbm_total_gb=FAKE_HBM_TOTAL_GB,
                                         timestamp=now) for c in ids}
        self._health = {c: ChipHealth(status=HealthStatus.HEALTHY,
                                      last_checked=now) for c in ids}
        self.initialized = False

    def initialize(self) -> None:
        self.initialized = True

    def shutdown(self) -> None:
        self.initialized = False

    def list_node_names(self) -> List[str]:
        return [self._node_name]

    def get_utilization(self, node_name: str) -> Dict[str, ChipUtilization]:
        if node_name != self._node_name:
            raise KeyError(node_name)
        return dict(self._util)

    def get_health(self, node_name: str) -> Dict[str, ChipHealth]:
        if node_name != self._node_name:
            raise KeyError(node_name)
        return dict(self._health)
