"""The device layer's interface: `GPUClient`, the counterpart of the JAX
package's `TPUClient` (discovery/discovery.py), with the methods the node
agent and the exporter call, under the same names.

`get_node_topology` is left out. A node's structure (which chips form a
slice, its shape, its links) is what the JAX control plane schedules on,
and it reads it from the node's labels (the JAX `kube/labels_tpu.py`); the
node's own device layer reports counters and health, by chip id.
"""

from __future__ import annotations

import abc
from typing import Dict, List

from .types import ChipHealth, ChipUtilization


class GPUClient(abc.ABC):
    @abc.abstractmethod
    def initialize(self) -> None: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    @abc.abstractmethod
    def list_node_names(self) -> List[str]:
        """Nodes this client can read (an agent's client reads one)."""

    @abc.abstractmethod
    def get_utilization(self, node_name: str) -> Dict[str, ChipUtilization]:
        """chip_id -> counters (duty cycle, device memory, power)."""

    @abc.abstractmethod
    def get_health(self, node_name: str) -> Dict[str, ChipHealth]:
        """chip_id -> health."""
