"""FaultLab: the deterministic, seed-driven fault-injection plane.

The port's own copy of the JAX package's faultlab, cut to the serving
engine's sites (the mesh's device loss included) and the host KV tier's: the same environment contract
(``KTWE_FAULT_SEED``, ``KTWE_FAULT_RATE``, ``KTWE_FAULT_SITES``) and the
same schedule, so one seed injects the same faults at the same crossings
in both packages.

A boundary the engine crosses carries a NAMED injection site::

    faultlab.site("engine.dispatch")

With no plan active (the default) a site call is one global read. Under
an active :class:`FaultPlan` every site call counts its per-site
occurrence and asks the schedule whether THIS occurrence fires. The
schedule is a pure function of (seed, site, occurrence): SHA-256 of the
triple against the plan's per-site rate. So a run's fault pattern is fixed
by its seed, two sites never perturb each other's schedules, and adding a
site does not reshuffle the faults of existing ones. A firing site raises
:class:`InjectedFault`, which the engine contains by the site's class.

Everything is process-local and thread-safe; `snapshot()` feeds the
``ktwe_fault_injections_total`` family and the ``faultlab`` block of
/v1/metrics.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, Optional, Tuple

ENV_SEED = "KTWE_FAULT_SEED"
ENV_RATE = "KTWE_FAULT_RATE"
ENV_SITES = "KTWE_FAULT_SITES"


class InjectedFault(RuntimeError):
    """A faultlab-scheduled failure at an engine site: the containment
    path under test must absorb it."""


class InjectedDeviceLoss(RuntimeError):
    """A device died under a meshed dispatch: the engine answers with the
    degraded-mesh evacuation (every live request ejected as a resume frame,
    the engine rebuilt on what remains), never with per-request failure."""


# The engine's and the host KV tier's sites: name -> (kind, what the fault
# models), as in the JAX package's table. A site of kind "error" raises
# InjectedFault, "device-loss" InjectedDeviceLoss.
SITES: Dict[str, Tuple[str, str]] = {
    "engine.dispatch": ("error", "decode/verify dispatch fault"),
    "engine.collect": ("error", "chunk-fetch/collect fault"),
    # Fires inside the overlapped commit phase, per request: commit
    # bookkeeping touches no device state, so containment is the
    # narrowest class of all — the one request fails, its round
    # co-tenants and the already-dispatched next round proceed.
    "engine.commit": ("error", "host-side commit bookkeeping fault "
                               "for one request"),
    "engine.prefill": ("error", "prompt-prefill fault mid-admission"),
    "engine.paged_admit": ("error", "paged-pool admission fault"),
    # Crossed only by an engine on a serving mesh, after engine.dispatch.
    "engine.device_loss": ("device-loss",
                           "device lost under a meshed dispatch"),
    # The host KV tier (models/kvhost.py): all three are CONTAINED by
    # construction — every degraded path ends in re-prefill, never wrong
    # tokens. A dma fault means the eviction victim discards exactly as
    # it did before the tier existed; a fetch fault or detected
    # corruption drops the host entry and the admission re-prefills the
    # block.
    "kvhost.dma": ("error", "device->host demotion copy fails — the "
                            "evicted block discards (pre-tier floor)"),
    "kvhost.fetch": ("error", "host->device prefetch fails — the "
                              "entry drops, admission re-prefills"),
    "kvhost.corrupt": ("error", "stored host block fails its checksum "
                                "— dropped, never restored"),
}

_lock = threading.Lock()          # leaf-only guard for the counters
_active: Optional["FaultPlan"] = None
_occurrences: Dict[str, int] = {}
_injections: Dict[str, int] = {}
_last: Optional[Tuple[str, int]] = None


class FaultPlan:
    """A deterministic fault schedule. ``decide(site, occurrence)`` is
    a pure function — SHA-256 over ``"{seed}:{site}:{occurrence}"``
    mapped to [0, 1) against the site's rate — so the same seed always
    fires the same occurrences at the same sites, regardless of thread
    timing, site call order, or which other sites exist."""

    def __init__(self, seed: int, rate: float = 0.05,
                 sites: Optional[Dict[str, float]] = None):
        self.seed = int(seed)
        self.rate = float(rate)
        # Per-site rate overrides; a `sites` dict restricts injection to
        # its entries (unlisted sites read rate 0).
        self.sites = dict(sites) if sites is not None else None

    def site_rate(self, name: str) -> float:
        if self.sites is None:
            return self.rate
        return float(self.sites.get(name, 0.0))

    def decide(self, name: str, occurrence: int) -> bool:
        rate = self.site_rate(name)
        if rate <= 0.0:
            return False
        digest = hashlib.sha256(
            f"{self.seed}:{name}:{occurrence}".encode()).digest()
        u = int.from_bytes(digest[:8], "big") / float(1 << 64)
        return u < rate

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, rate={self.rate}, "
                f"sites={self.sites})")


class TargetedPlan(FaultPlan):
    """Fire at EXPLICIT (site, occurrence) pairs, to land a fault inside
    a specific window whatever the hash schedule thinks. Occurrence
    numbering is the per-site crossing count, so the same code path
    always fires the same crossing. Unlisted sites never fire."""

    def __init__(self, targets: Dict[str, object]):
        super().__init__(seed=0, rate=0.0, sites={})
        self.targets = {name: set(occs)          # type: ignore[arg-type]
                        for name, occs in targets.items()}

    def site_rate(self, name: str) -> float:
        return 1.0 if self.targets.get(name) else 0.0

    def decide(self, name: str, occurrence: int) -> bool:
        return occurrence in self.targets.get(name, ())

    def __repr__(self) -> str:
        return f"TargetedPlan(targets={self.targets})"


def activate(fault_plan: FaultPlan) -> FaultPlan:
    """Install `fault_plan` and reset the occurrence/injection
    counters — activation is the start of a fresh deterministic
    schedule (occurrence numbering restarts at 0 per site)."""
    global _active, _last
    with _lock:
        _occurrences.clear()
        _injections.clear()
        _last = None
    _active = fault_plan
    return fault_plan


def deactivate() -> None:
    global _active
    _active = None


def from_env() -> Optional[FaultPlan]:
    """The replay entry point: ``KTWE_FAULT_SEED=N`` builds the plan a
    failing run printed (rate from ``KTWE_FAULT_RATE``, an optional
    comma-separated ``KTWE_FAULT_SITES`` restriction). Returns None
    when no seed is exported — faultlab stays inert."""
    raw = os.environ.get(ENV_SEED, "")
    if not raw:
        return None
    rate = float(os.environ.get(ENV_RATE, "0.05"))
    names = [s for s in os.environ.get(ENV_SITES, "").split(",") if s]
    sites = {n: rate for n in names} if names else None
    return FaultPlan(int(raw), rate=rate, sites=sites)


def site(name: str) -> None:
    """Declare one crossing of the named fault boundary. Counts the
    occurrence and, when the active plan's schedule says this one
    fires, raises :class:`InjectedFault`. The no-plan path is a single
    global read."""
    global _last
    p = _active
    if p is None:
        return
    with _lock:
        occ = _occurrences.get(name, 0)
        _occurrences[name] = occ + 1
        fire = p.decide(name, occ)
        if fire:
            _injections[name] = _injections.get(name, 0) + 1
            _last = (name, occ)
    if fire:
        kind = SITES.get(name, ("error", ""))[0]
        detail = (f"[faultlab] injected {kind} fault: site={name} "
                  f"occurrence={occ} seed={p.seed} "
                  f"(replay: {ENV_SEED}={p.seed})")
        if kind == "device-loss":
            raise InjectedDeviceLoss(detail)
        raise InjectedFault(detail)


def injections_total() -> int:
    with _lock:
        return sum(_injections.values())


def snapshot() -> Dict[str, object]:
    """Counters for /v1/metrics: total + per-site injections, per-site
    occurrences, the active seed (None when inert), and the last
    injection — everything an operator needs to replay a red run."""
    p = _active
    with _lock:
        return {
            "active": p is not None,
            "seed": p.seed if p is not None else None,
            "injections_total": sum(_injections.values()),
            "injections_by_site": dict(_injections),
            "occurrences_by_site": dict(_occurrences),
            "last": (f"{_last[0]}#{_last[1]}"
                     if _last is not None else None),
        }
