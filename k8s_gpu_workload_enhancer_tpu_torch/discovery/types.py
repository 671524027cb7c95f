"""What the node agent and the exporter need of the JAX package's
discovery/types.py: the port's own copy of `HealthStatus`,
`ChipUtilization` and `ChipHealth`, with the same fields and defaults.

The slice model of that module (generations, slice shapes, ICI links,
coordinates) describes a TPU slice's structure; it stays with the JAX
control plane, which reads a node's structure from its labels. A GPU
node's agent reports counters and health by chip id only.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List


class HealthStatus(str, enum.Enum):
    HEALTHY = "Healthy"
    DEGRADED = "Degraded"
    UNHEALTHY = "Unhealthy"
    UNKNOWN = "Unknown"


@dataclass
class ChipHealth:
    status: HealthStatus = HealthStatus.HEALTHY
    reasons: List[str] = field(default_factory=list)
    ici_link_errors: int = 0
    hbm_ecc_errors: int = 0
    throttling_reasons: List[str] = field(default_factory=list)
    temperature_c: float = 0.0
    last_checked: float = 0.0

    @property
    def schedulable(self) -> bool:
        return self.status in (HealthStatus.HEALTHY, HealthStatus.DEGRADED)


@dataclass
class ChipUtilization:
    """A chip's counters. On a GPU node `duty_cycle_pct` is NVML's
    `utilization.gpu` (the share of the last sample period in which a
    kernel ran) and HBM is the card's device memory."""

    duty_cycle_pct: float = 0.0
    tensorcore_util_pct: float = 0.0
    hbm_used_gb: float = 0.0
    hbm_total_gb: float = 0.0
    power_watts: float = 0.0
    temperature_c: float = 0.0
    timestamp: float = 0.0
