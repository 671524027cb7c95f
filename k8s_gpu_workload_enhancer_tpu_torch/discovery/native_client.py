"""`NativeGPUClient`: the node's device layer on a GPU node, the
counterpart of the JAX package's `NativeTPUClient`
(discovery/native_client.py). One node, two sources, as the JAX shim has:

- `"nvml"` in the place of `"libtpu"`: the card's own counters through
  NVML (discovery/nvml.py). `duty_cycle_pct` is `utilization.gpu`;
  `hbm_used_gb` / `hbm_total_gb` are nvmlMemory_t's `used` / `total`
  over 2^30, as the libtpu reader divides; `power_watts` is
  nvmlDeviceGetPowerUsage's mW / 1000; `temperature_c` the GPU die
  sensor. `tensorcore_util_pct` is 0, as the libtpu reader sends none.
  Health is 0 when every query of a device answers; a device whose query
  answers NVML_ERROR_GPU_IS_LOST is unhealthy with NVML's text as the
  reason, and any other NVML error raises.
- `"file:<path>"`: the whitespace table `index duty tc_util hbm_used
  hbm_total power temp health`, parsed by the JAX shim's rules
  (`shim.cc` ReadFileSamples): `#` and empty lines skipped, each line read
  as sscanf reads it, a row of fewer than 5 fields dropped, a missing
  power, temperature or health read as 0; re-read on every read, so a
  sidecar can stream counters. A row whose total is 0 reports 0 (the JAX
  client substitutes its TPU generation's capacity).

Chip ids are the JAX form, `f"{node}-chip-{index}"`; `index` is NVML's
(PCI order, not CUDA's), as libtpu's device id is the TPU runtime's.
`initialize()` raises when the source cannot be opened; a `"libtpu"`
source is refused with a ValueError that names `nvml`.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

from . import nvml
from .client import GPUClient
from .types import ChipHealth, ChipUtilization, HealthStatus

_HEALTH_MAP = {0: HealthStatus.HEALTHY, 1: HealthStatus.DEGRADED,
               2: HealthStatus.UNHEALTHY}

# sscanf's %d and %lf, each after optional white space.
_SCAN_INT = re.compile(r"\s*([+-]?\d+)")
_SCAN_FLOAT = re.compile(
    r"\s*([+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|inf(?:inity)?|nan))", re.IGNORECASE)
# index duty tc_util hbm_used hbm_total power temp health
_ROW = (_SCAN_INT,) + (_SCAN_FLOAT,) * 6 + (_SCAN_INT,)


def _scan(line: str) -> list:
    """The fields sscanf("%d %lf %lf %lf %lf %lf %lf %d") converts, up to
    the first it cannot."""
    out, pos = [], 0
    for pattern in _ROW:
        m = pattern.match(line, pos)
        if m is None:
            break
        text = m.group(1)
        out.append(int(text) if pattern is _SCAN_INT else float(text))
        pos = m.end()
    return out


def read_file_samples(path: str) -> List[nvml.ChipSample]:
    """The table at `path` (raises OSError when it cannot be opened)."""
    samples = []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith(("#", "\n")):
                continue
            fields = _scan(line)
            if len(fields) < 5:
                continue
            # Power and temperature 0.0, health 0 where the row stops.
            samples.append(nvml.ChipSample(
                *fields, *[0.0, 0.0, 0][len(fields) - 5:]))
    return samples


class NativeGPUClient(GPUClient):
    """A node agent's client: one node, `source` "nvml" or
    "file:<path>"; `nvml_path` is the library's path."""

    def __init__(self, node_name: str, source: str,
                 nvml_path: str = nvml.DEFAULT_PATH):
        self._node_name = node_name
        self._source = source
        self._nvml_path = nvml_path
        self._session: Optional[nvml.Session] = None
        self._chip_count = 0

    def initialize(self) -> None:
        if self._source == "nvml":
            self.shutdown()             # a second initialize pairs the first
            self._session = nvml.Session(self._nvml_path)
            try:
                self._chip_count = self._session.device_count()
            except nvml.NvmlError:
                self.shutdown()
                raise
        elif self._source.startswith("file:"):
            try:
                self._chip_count = len(read_file_samples(self._source[5:]))
            except OSError as e:
                raise RuntimeError(
                    f"device source {self._source!r} cannot be opened: "
                    f"{e}") from e
        elif self._source == "libtpu" or self._source.startswith("libtpu:"):
            raise ValueError(
                f"source {self._source!r}: a GPU node has no libtpu; its "
                "counters come from 'nvml' (or a 'file:<path>' table)")
        else:
            raise ValueError(f"unknown device source {self._source!r}: "
                             "want 'nvml' or 'file:<path>'")

    def shutdown(self) -> None:
        session, self._session = self._session, None
        if session is not None:
            session.close()

    def list_node_names(self) -> List[str]:
        return [self._node_name]

    def samples(self) -> List[Tuple[nvml.ChipSample, str]]:
        """Every device's sample and, for a lost device, NVML's text."""
        if self._source.startswith("file:"):
            return [(s, "") for s in read_file_samples(self._source[5:])]
        if self._session is None:
            raise RuntimeError("NativeGPUClient is not initialized")
        out = []
        for index in range(self._chip_count):
            try:
                out.append((self._session.sample(index), ""))
            except nvml.NvmlError as e:
                if e.code != nvml.NVML_ERROR_GPU_IS_LOST:
                    raise
                out.append((nvml.ChipSample(index=index, health=2), e.text))
        return out

    def _chip_id(self, s: nvml.ChipSample) -> str:
        return f"{self._node_name}-chip-{s.index}"

    def get_utilization(self, node_name: str) -> Dict[str, ChipUtilization]:
        if node_name != self._node_name:
            raise KeyError(node_name)
        now = time.time()
        return {self._chip_id(s): ChipUtilization(
                    duty_cycle_pct=s.duty_cycle_pct,
                    tensorcore_util_pct=s.tensorcore_util_pct,
                    hbm_used_gb=s.hbm_used_gb, hbm_total_gb=s.hbm_total_gb,
                    power_watts=s.power_watts,
                    temperature_c=s.temperature_c, timestamp=now)
                for s, _ in self.samples()}

    def get_health(self, node_name: str) -> Dict[str, ChipHealth]:
        if node_name != self._node_name:
            raise KeyError(node_name)
        out: Dict[str, ChipHealth] = {}
        now = time.time()
        for s, lost in self.samples():
            status = _HEALTH_MAP.get(s.health, HealthStatus.UNKNOWN)
            out[self._chip_id(s)] = ChipHealth(
                status=status,
                reasons=[lost] if lost else
                [] if status == HealthStatus.HEALTHY
                else [f"shim health={s.health}"],
                temperature_c=s.temperature_c, last_checked=now)
        return out
