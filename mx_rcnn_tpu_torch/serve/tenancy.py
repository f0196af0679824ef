"""Multi-tenant identity, token-bucket quotas, and fair-share policy.

The port's own copy of ``mx_rcnn_tpu/serve/tenancy.py``, less its
``QuotaGovernor``: that bridge from ``ctrl/slo.py``'s burn alerts to
:meth:`TenancyPolicy.tighten` / :meth:`TenancyPolicy.restore` comes with
its caller.  Its other callers in the JAX package (the RPC surface, the
fleet) are not ported yet either; the engine's admission and the batcher
use it here.

One :class:`TenancyPolicy` instance is shared by every admission layer
— the RPC surface resolves wire tokens, ``serve/fleet.py`` charges the
quota exactly once per logical request, ``serve/batcher.py`` reads
weights/priorities for weighted-fair pack composition — so a tenant's
identity, budget, and share are decided once, from one table.

Design constraints, in the order they bite:

* **Bounded label cardinality.**  Metric labels only ever come from
  :meth:`TenancyPolicy.label`, which folds any token outside the
  configured table (plus the default tenant) to ``"other"`` — a
  1000-distinct-token flood yields at most ``len(table) + 2`` series
  per metric (the JAX package's tests/test_tenancy.py pins this with a hammer).
* **Unknown is not an error.**  :meth:`resolve` maps unknown/absent
  tokens to the default tenant: an unconfigured caller shares the
  default bucket; it never 500s (serve/rpc.py).
* **Quota is not shed.**  The token bucket answers *before* placement;
  ``QuotaExceeded`` is the tenant's own budget talking, not fleet
  pressure, so it must never feed the autoscaler's shed-rate signal
  (serve/fleet.py keeps a separate ``quota`` counter).
* **Burn-gated tightening.**  ctrl/slo.py per-tenant burn alerts call
  :meth:`tighten` / :meth:`restore` (through the JAX package's
  ``QuotaGovernor``) — one misbehaving tenant's admitted rate shrinks;
  the fleet never sheds on its behalf.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional


__all__ = [
    "DEFAULT_TENANT", "OTHER_LABEL", "TenantSpec", "TenancyPolicy", "parse_table",
]

DEFAULT_TENANT = "default"
OTHER_LABEL = "other"


@dataclass(frozen=True)
class TenantSpec:
    """One row of the tenant table (cfg.serve.tenancy)."""

    name: str
    weight: float = 1.0    # fair share of each pack (relative)
    rate: float = 0.0      # admitted requests/s; <= 0 means unlimited
    burst: float = 1.0     # token-bucket capacity (max burst above rate)
    priority: int = 1      # lower drains earlier across tenants


_SPEC_KEYS = ("weight", "rate", "burst", "priority")


def parse_table(spec: str) -> Dict[str, TenantSpec]:
    """Parse the compact table string from ``cfg.serve.tenancy.table``.

    Format: ``name:weight=4,rate=50,burst=20,priority=0;name2:...`` —
    semicolon-separated tenants, comma-separated ``key=value`` knobs,
    every knob optional.  Unknown keys raise (a typo'd quota is a
    silently-unlimited tenant otherwise).
    """
    table: Dict[str, TenantSpec] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, kvs = entry.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant entry missing a name: {entry!r}")
        kwargs: Dict[str, float] = {}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep, val = kv.partition("=")
            key = key.strip()
            if not sep or key not in _SPEC_KEYS:
                raise ValueError(
                    f"tenant {name!r}: unknown knob {kv!r} "
                    f"(expected one of {_SPEC_KEYS})"
                )
            kwargs[key] = int(val) if key == "priority" else float(val)
        table[name] = TenantSpec(name=name, **kwargs)  # type: ignore[arg-type]
    return table


class _Bucket:
    __slots__ = ("tokens", "last", "factor")

    def __init__(self, burst: float) -> None:
        self.tokens = max(1.0, burst)  # start full: first burst admits
        self.last: Optional[float] = None
        self.factor = 1.0              # 1.0 = full quota; <1 = tightened


class TenancyPolicy:
    """The shared tenant table + per-tenant token buckets.

    Thread-safe; the bucket lock is a leaf (never held across a
    blocking call) so it composes with every serving lock order.
    """

    def __init__(
        self,
        table: Dict[str, TenantSpec],
        default_tenant: str = DEFAULT_TENANT,
        tighten_factor: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.table = dict(table)
        self.default_tenant = default_tenant
        self.tighten_factor = float(tighten_factor)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets = {
            name: _Bucket(spec.burst) for name, spec in self.table.items()
        }
        # The bounded label vocabulary: configured tenants + the default
        # tenant + the fold-bucket.  Nothing else may ever label a metric.
        self._labels = frozenset(self.table) | {default_tenant, OTHER_LABEL}

    @classmethod
    def from_config(
        cls, tenancy_cfg, clock: Callable[[], float] = time.monotonic
    ) -> Optional["TenancyPolicy"]:
        """None when tenancy is disabled — every call site stays on the
        exact pre-tenancy code path (bit-identical metric series)."""
        if not tenancy_cfg.enabled:
            return None
        return cls(
            parse_table(tenancy_cfg.table),
            default_tenant=tenancy_cfg.default_tenant,
            clock=clock,
        )

    # -- identity ----------------------------------------------------------

    def resolve(self, token) -> str:
        """Wire token -> tenant name.  Unknown/absent/garbage tokens all
        land on the default tenant (they share its bucket) — resolution
        never raises, so a bad token can never 500."""
        if token is None:
            return self.default_tenant
        if not isinstance(token, str):
            token = str(token)
        return token if token in self.table else self.default_tenant

    def label(self, tenant) -> str:
        """Tenant name -> metric label, folded to the bounded vocabulary
        (configured table + default + ``"other"``)."""
        if tenant is None:
            return self.default_tenant
        if not isinstance(tenant, str):
            tenant = str(tenant)
        if tenant in self.table or tenant == self.default_tenant:
            return tenant
        return OTHER_LABEL

    def label_values(self) -> tuple:
        """Every label this policy can emit — the cardinality bound."""
        return tuple(sorted(self._labels))

    def spec(self, tenant: str) -> TenantSpec:
        return self.table.get(tenant) or TenantSpec(name=tenant)

    def weight(self, tenant) -> float:
        return max(self.spec(self.resolve(tenant)).weight, 1e-6)

    def priority(self, tenant) -> int:
        return self.spec(self.resolve(tenant)).priority

    # -- quota (token bucket) ----------------------------------------------

    def admit(self, tenant: str, now: Optional[float] = None) -> bool:
        """Charge one token from ``tenant``'s bucket.  True = admitted.
        Tenants without a configured rate are unlimited."""
        spec = self.table.get(tenant)
        if spec is None or spec.rate <= 0:
            return True
        if now is None:
            now = self._clock()
        with self._lock:
            b = self._buckets[tenant]
            rate = spec.rate * b.factor
            cap = max(1.0, spec.burst * b.factor)
            if b.last is not None and now > b.last:
                b.tokens = min(cap, b.tokens + (now - b.last) * rate)
            b.tokens = min(b.tokens, cap)
            b.last = now
            if b.tokens >= 1.0:
                b.tokens -= 1.0
                return True
            return False

    def retry_after_s(self, tenant: str) -> float:
        """Seconds until one token accrues — the wire Retry-After hint."""
        spec = self.table.get(tenant)
        if spec is None or spec.rate <= 0:
            return 1.0
        with self._lock:
            factor = self._buckets[tenant].factor
        return min(60.0, max(1.0, 1.0 / max(spec.rate * factor, 1e-6)))

    # -- burn governor hooks -----------------------------------------------

    def tighten(self, tenant: str, factor: Optional[float] = None) -> bool:
        """Scale ``tenant``'s admitted rate down (burn-alert degrade
        action).  Returns True when the factor actually changed."""
        if tenant not in self._buckets:
            return False
        f = self.tighten_factor if factor is None else float(factor)
        f = min(max(f, 0.01), 1.0)
        with self._lock:
            b = self._buckets[tenant]
            if b.factor == f:
                return False
            b.factor = f
            b.tokens = min(b.tokens, max(1.0, self.table[tenant].burst * f))
            return True

    def restore(self, tenant: str) -> bool:
        """Undo :meth:`tighten` once the tenant's burn clears."""
        if tenant not in self._buckets:
            return False
        with self._lock:
            b = self._buckets[tenant]
            if b.factor == 1.0:
                return False
            b.factor = 1.0
            return True

    def snapshot(self) -> dict:
        """Per-tenant quota state for ``stats()`` surfaces."""
        with self._lock:
            return {
                name: {
                    "factor": b.factor,
                    "tokens": round(b.tokens, 3),
                    "rate": self.table[name].rate,
                    "weight": self.table[name].weight,
                    "priority": self.table[name].priority,
                }
                for name, b in self._buckets.items()
            }

