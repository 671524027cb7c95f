"""Serving-path tenant metering and per-tenant budget admission.

The port's copy of the part of the JAX package's cost/cost_engine.py that
the serve main uses, with the same names and arithmetic:

- `BudgetPeriod`, `EnforcementPolicy` and `BudgetScope` (its TENANT scope:
  one budget per inference tenant, the request's `tenant` field or
  `x-ktwe-tenant` header);
- `period_start_of` and `period_next_start`, the UTC calendar periods a
  budget covers (the budget-exhausted 429's Retry-After runs to the next
  period start);
- `Budget` and `CostEngine`'s serving half: `create_budget`,
  `add_serving_spend`, `serving_admission`, with a budget's spend reset in
  place when its calendar period rolls over;
- `TenantMeter`: tokens and chip-seconds per tenant and priority class,
  priced at a $/chip-hour rate and charged against the engine's budgets.

Left out, since the serve never reads them: the other budget scopes,
pricing tables, usage records and their lifecycle, alerts, throttling,
recommendations, chargeback reports and persistence. The JAX module
imports `discovery.types` and `utils.log` for those; this one needs the
standard library only.
"""

from __future__ import annotations

import calendar
import enum
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


class BudgetScope(str, enum.Enum):
    # Serving-path identity: one budget per inference tenant, enforced by
    # the serve's admission as budget-exhausted 429s.
    TENANT = "Tenant"


class BudgetPeriod(str, enum.Enum):
    DAILY = "Daily"
    WEEKLY = "Weekly"
    MONTHLY = "Monthly"
    QUARTERLY = "Quarterly"


def period_start_of(period: BudgetPeriod,
                    now: Optional[float] = None) -> float:
    """Start of the calendar period (UTC) containing `now`: a Monthly
    budget covers this month's spend from day 1."""
    t = time.gmtime(now if now is not None else time.time())
    if period == BudgetPeriod.DAILY:
        s = (t.tm_year, t.tm_mon, t.tm_mday)
    elif period == BudgetPeriod.WEEKLY:
        # Back up to Monday.
        day = calendar.timegm((t.tm_year, t.tm_mon, t.tm_mday, 0, 0, 0))
        return float(day - t.tm_wday * 86400)
    elif period == BudgetPeriod.QUARTERLY:
        s = (t.tm_year, 3 * ((t.tm_mon - 1) // 3) + 1, 1)
    else:                                  # Monthly
        s = (t.tm_year, t.tm_mon, 1)
    return float(calendar.timegm((*s, 0, 0, 0)))


def period_next_start(period: BudgetPeriod,
                      now: Optional[float] = None) -> float:
    """Start of the next calendar period after `now` (UTC): where an
    exhausted tenant's spend resets, the budget-exhausted 429's
    Retry-After."""
    start = period_start_of(period, now)
    t = time.gmtime(start)
    if period == BudgetPeriod.DAILY:
        return start + 86400.0
    if period == BudgetPeriod.WEEKLY:
        return start + 7 * 86400.0
    if period == BudgetPeriod.QUARTERLY:
        mon, year = t.tm_mon + 3, t.tm_year
    else:                                  # Monthly
        mon, year = t.tm_mon + 1, t.tm_year
    if mon > 12:
        mon -= 12
        year += 1
    return float(calendar.timegm((year, mon, 1, 0, 0, 0)))


class EnforcementPolicy(str, enum.Enum):
    ALERT = "Alert"             # tracked, never refuses
    BLOCK = "Block"             # refuses fresh requests once spent


@dataclass
class Budget:
    budget_id: str
    name: str
    limit: float
    scope: BudgetScope
    scope_value: str                 # the tenant
    period: BudgetPeriod = BudgetPeriod.MONTHLY
    enforcement: EnforcementPolicy = EnforcementPolicy.ALERT
    current_spend: float = 0.0
    period_start: float = field(default_factory=time.time)


class CostEngine:
    """Per-tenant serving budgets. Only BLOCK budgets gate admission; the
    serving path consults them per request, so each call rolls a budget
    whose calendar period has ended (a Daily budget reopens at midnight
    UTC without an operator touching it)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._budgets: Dict[str, Budget] = {}

    def create_budget(self, name: str, limit: float, scope: BudgetScope,
                      scope_value: str = "",
                      period: BudgetPeriod = BudgetPeriod.MONTHLY,
                      enforcement: EnforcementPolicy = EnforcementPolicy.ALERT
                      ) -> Budget:
        b = Budget(budget_id=f"bud-{uuid_mod.uuid4().hex[:8]}", name=name,
                   limit=limit, scope=scope, scope_value=scope_value,
                   period=period, enforcement=enforcement,
                   period_start=period_start_of(period))
        with self._lock:
            self._budgets[b.budget_id] = b
        return b

    def _roll_period(self, b: Budget, now: float) -> None:
        """Reset a budget whose calendar period has rolled over (called
        with the lock held)."""
        if now >= period_next_start(b.period, b.period_start):
            b.period_start = period_start_of(b.period, now)
            b.current_spend = 0.0

    @staticmethod
    def _in_scope_tenant(b: Budget, tenant: str) -> bool:
        return b.scope == BudgetScope.TENANT and b.scope_value == tenant

    def add_serving_spend(self, tenant: str, cost: float) -> None:
        """Charge serving spend (TenantMeter's chip-seconds priced into
        dollars) against every budget covering `tenant`."""
        if cost <= 0:
            return
        now = time.time()
        with self._lock:
            for b in self._budgets.values():
                if self._in_scope_tenant(b, tenant):
                    self._roll_period(b, now)
                    b.current_spend += cost

    def serving_admission(self, tenant: str) -> Tuple[bool, str, float]:
        """(allowed, reason, retry_after_s) for one serving request: a
        BLOCK budget of `tenant` at or over its limit refuses it until its
        calendar period resets (the retry hint, at least 1 s)."""
        now = time.time()
        with self._lock:
            for b in self._budgets.values():
                if b.enforcement != EnforcementPolicy.BLOCK:
                    continue
                if not self._in_scope_tenant(b, tenant):
                    continue
                self._roll_period(b, now)
                if b.current_spend >= b.limit:
                    retry = max(1.0, period_next_start(b.period, now) - now)
                    return False, (f"budget {b.name} exhausted "
                                   f"({b.current_spend:.2f}/"
                                   f"{b.limit:.2f})"), retry
        return True, "", 0.0


PRIORITY_CLASSES = ("interactive", "batch")


class TenantMeter:
    """Per-tenant serving meter: requests, tokens and chip-seconds by
    priority class, priced into dollars against a CostEngine's budgets.

    The serve calls `record()` once per terminal view (a timeout's or a
    disconnected stream's partial tokens ran on the card too) and
    `admission()` before it admits a fresh request. Resumes bypass
    admission (their first admission paid; refusing a preempted batch
    continuation would turn the preemption into a kill) but their tokens
    still meter. Spend is chip-seconds at `chip_hour_rate`.

    Thread-safe; budget updates are in-memory dict walks."""

    def __init__(self, engine: Optional[CostEngine] = None,
                 chip_hour_rate: float = 1.20):
        self._engine = engine
        self.chip_hour_rate = float(chip_hour_rate)
        self._lock = threading.Lock()
        self._tenants: Dict[str, Dict[str, Dict[str, float]]] = {}
        self._by_priority: Dict[str, Dict[str, float]] = {
            p: {"requests": 0, "tokens": 0, "chip_seconds": 0.0}
            for p in PRIORITY_CLASSES}
        self.budget_rejections_total = 0

    def record(self, tenant: str, priority: str, tokens: int,
               chip_seconds: float, count_request: bool = True) -> float:
        """Meter one terminal view; returns its priced cost.
        `count_request=False` for a migrated view (preempt or drain hop):
        its tokens and chip-seconds are work the tenant pays for, but one
        generation counts one request, where it completes."""
        if priority not in PRIORITY_CLASSES:
            priority = "interactive"
        cost = max(0.0, chip_seconds) / 3600.0 * self.chip_hour_rate
        with self._lock:
            t = self._tenants.setdefault(tenant, {
                p: {"requests": 0, "tokens": 0, "chip_seconds": 0.0}
                for p in PRIORITY_CLASSES})
            for bucket in (t[priority], self._by_priority[priority]):
                if count_request:
                    bucket["requests"] += 1
                bucket["tokens"] += int(tokens)
                bucket["chip_seconds"] += max(0.0, chip_seconds)
        if self._engine is not None:
            self._engine.add_serving_spend(tenant, cost)
        return cost

    def admission(self, tenant: str) -> Tuple[bool, str, float]:
        """(allowed, reason, retry_after_s) of one fresh request; without
        a CostEngine every tenant is admitted (metering only)."""
        if self._engine is None:
            return True, "", 0.0
        ok, reason, retry = self._engine.serving_admission(tenant)
        if not ok:
            with self._lock:
                self.budget_rejections_total += 1
        return ok, reason, retry

    def snapshot(self) -> Dict[str, object]:
        """The /v1/metrics `tenancy` block: the per-priority sources of
        the ktwe_serving_tenant_* families and the per-tenant breakdown."""
        with self._lock:
            return {
                "active_tenants": len(self._tenants),
                "budget_rejections_total": self.budget_rejections_total,
                "by_priority": {p: dict(v) for p, v in
                                self._by_priority.items()},
                "tenants": {name: {p: dict(v) for p, v in t.items()}
                            for name, t in self._tenants.items()},
            }
