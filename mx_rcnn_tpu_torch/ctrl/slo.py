"""Declarative SLOs + multi-window burn-rate alerting over the obs plane.

The port's own copy of ``mx_rcnn_tpu/ctrl/slo.py``: the SLOs, the burn
rule, the journal events and the budget gauge are the JAX package's.

An :class:`SLO` names a good-event fraction target over the metrics the
serving stack already exports (obs/metrics.py):

* ``availability`` — completed / (completed + failed + shed) from the
  fleet's ``fleet_requests_total{outcome=...}`` counters.  A shed
  request counts against availability: the fleet refused a user.
* ``latency`` — requests served under ``threshold_s`` as a fraction of
  all served, from the ``serve_request_latency_seconds`` histogram
  buckets, optionally restricted to one degrade level
  (``level="full"``) so "p99 of full-quality responses" is its own SLO.

The :class:`SLOEngine` evaluates them over ``Registry`` snapshots — fed
live (one :meth:`SLOEngine.observe` per control period) or replayed
from a journal's ``metrics_flush`` records (:meth:`SLOEngine.replay`),
so a post-hoc report computes the exact same burn rates the live loop
saw.  Alerting is the SRE multi-window burn-rate rule: page when the
error-budget burn exceeds ``burn_factor`` over BOTH a fast and a slow
window (fast catches the step change, slow filters blips); the alert
clears when the fast window recovers.  Transitions are journaled as
typed ``slo_burn_start`` / ``slo_burn_stop`` events and the remaining
budget is exported as an ``slo_error_budget_remaining{slo=...}`` gauge
on ``/metrics``.

Host-side only: nothing here touches the card.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Optional, Sequence

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.obs.metrics import (
    Registry,
    SnapshotWindow,
    parse_labels,
    percentile_from_counts,
    snapshot_delta,
)

log = logging.getLogger("mx_rcnn_tpu_torch.ctrl")

__all__ = ["SLO", "SLOEngine", "default_slos", "good_total",
           "merged_percentile", "tenant_slos"]

AVAILABILITY_METRIC = "fleet_requests_total"
LATENCY_METRIC = "serve_request_latency_seconds"


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective: ``target`` fraction of events must be good."""

    name: str
    target: float                       # good fraction in (0, 1)
    kind: str = "availability"          # "availability" | "latency"
    threshold_s: Optional[float] = None  # latency: good = under this
    level: Optional[str] = None          # latency: one degrade level only
    # Tenant-scoped SLO (serve/tenancy.py): only events labeled
    # tenant=<this> count.  The label set is bounded by the configured
    # tenant table, so per-tenant SLOs can't explode either.
    tenant: Optional[str] = None

    def __post_init__(self) -> None:
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "latency" and self.threshold_s is None:
            raise ValueError("latency SLO needs threshold_s")


def good_total(slo: SLO, snapshot: dict) -> tuple[float, float]:
    """(good, total) events for ``slo`` in one snapshot — cumulative or
    a :func:`~mx_rcnn_tpu_torch.obs.metrics.snapshot_delta` window (histogram
    summaries carry raw bucket counts either way)."""
    if slo.kind == "availability":
        series = snapshot.get(AVAILABILITY_METRIC, {})
        good = total = 0.0
        for label, v in series.items():
            if isinstance(v, dict):
                continue
            labels = parse_labels(label)
            if slo.tenant is not None and \
                    labels.get("tenant") != slo.tenant:
                continue
            if labels.get("outcome") == "quota":
                # The tenant's own budget talking (a contractual 429 +
                # Retry-After), not the fleet refusing a user: quota
                # rejections burn neither the fleet-wide budget nor the
                # capped tenant's own.
                continue
            total += v
            if labels.get("outcome") == "completed":
                good += v
        return good, total
    good = total = 0.0
    for label, summ in snapshot.get(LATENCY_METRIC, {}).items():
        if not isinstance(summ, dict):
            continue
        labels = parse_labels(label)
        if slo.level is not None and labels.get("level") != slo.level:
            continue
        if slo.tenant is not None and labels.get("tenant") != slo.tenant:
            continue
        le = summ.get("le") or []
        counts = summ.get("buckets") or []
        total += summ.get("count", 0)
        good += sum(
            c for b, c in zip(le, counts) if b <= slo.threshold_s
        )
    return good, total


def merged_percentile(
    snapshot: dict, q: float,
    name: str = LATENCY_METRIC,
    level: Optional[str] = None,
) -> Optional[float]:
    """Quantile over a histogram family with all label series merged
    (optionally filtered to one degrade level) — the autoscaler's
    windowed-p99 pressure signal."""
    merged: Optional[list[float]] = None
    le: list[float] = []
    for label, summ in snapshot.get(name, {}).items():
        if not isinstance(summ, dict):
            continue
        if level is not None and parse_labels(label).get("level") != level:
            continue
        counts = summ.get("buckets") or []
        if merged is None:
            merged = [0.0] * len(counts)
            le = summ.get("le") or []
        if len(counts) == len(merged):
            merged = [m + c for m, c in zip(merged, counts)]
    if merged is None:
        return None
    return percentile_from_counts(le, merged, q)


def default_slos(ctrl_cfg) -> tuple[SLO, ...]:
    """The stock pair driven by ``cfg.ctrl``: availability + latency."""
    return (
        SLO("availability", target=ctrl_cfg.availability_target),
        SLO(
            "latency", target=ctrl_cfg.latency_target, kind="latency",
            threshold_s=ctrl_cfg.latency_threshold_s,
        ),
    )


def tenant_slos(ctrl_cfg, tenants: Sequence[str]) -> tuple[SLO, ...]:
    """The :func:`default_slos` pair instantiated per tenant, over the
    tenant-labeled series (serve/tenancy.py).  SLO names embed the
    tenant (``availability[victim]``) so the budget gauge, burn alerts,
    and verdict table attribute blame by name alone."""
    out: list[SLO] = []
    for t in tenants:
        out.append(SLO(
            f"availability[{t}]", target=ctrl_cfg.availability_target,
            tenant=t,
        ))
        out.append(SLO(
            f"latency[{t}]", target=ctrl_cfg.latency_target,
            kind="latency", threshold_s=ctrl_cfg.latency_threshold_s,
            tenant=t,
        ))
    return tuple(out)


class SLOEngine:
    """Evaluate SLOs over snapshots; journal burn alerts; export budget.

    One clock rules the window: pass a consistent ``t`` to
    :meth:`observe` (the built-in loop uses ``time.monotonic``; journal
    replay uses the records' wall ``ts``).  Thread-safe.
    """

    def __init__(
        self,
        slos: Sequence[SLO],
        *,
        registry: Optional[Registry] = None,
        fast_s: float = 300.0,
        slow_s: float = 3600.0,
        burn_factor: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        on_alert: Optional[Callable[[str, SLO, dict], None]] = None,
    ) -> None:
        if fast_s <= 0 or slow_s < fast_s:
            raise ValueError("need 0 < fast_s <= slow_s")
        self.slos = tuple(slos)
        # Alert hook: called as on_alert("start"|"stop", slo, payload)
        # on every burn transition.  serve/tenancy.py::QuotaGovernor
        # attaches here so a tenant-scoped burn tightens only that
        # tenant's quota instead of shedding the fleet.
        self.on_alert = on_alert
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.burn_factor = float(burn_factor)
        self._registry = registry if registry is not None else obs.registry()
        self._clock = clock
        self._window = SnapshotWindow(
            self._registry, horizon_s=self.slow_s * 1.2 + 60.0
        )
        self._lock = threading.Lock()
        self._baseline: Optional[dict] = None
        self._active: dict[str, float] = {}   # slo name -> alert start t
        self._worst: dict[str, float] = {}
        self._states: dict[str, dict] = {}
        self.alerts: list[dict] = []          # start/stop transitions
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- evaluation --------------------------------------------------------

    def _burn(self, slo: SLO, delta: dict) -> tuple[float, float]:
        """(burn rate, total events) over one windowed delta."""
        good, total = good_total(slo, delta)
        if total <= 0:
            return 0.0, 0.0
        bad_frac = (total - good) / total
        return bad_frac / (1.0 - slo.target), total

    def observe(self, t: Optional[float] = None,
                snapshot: Optional[dict] = None) -> dict:
        """One evaluation: record a snapshot, update burn/budget per
        SLO, fire/clear alerts.  Returns {slo name: state dict}."""
        t = self._clock() if t is None else float(t)
        snap = self._window.observe(t, snapshot)
        with self._lock:
            if self._baseline is None:
                self._baseline = snap
            baseline = self._baseline
        cum = snapshot_delta(baseline, snap)
        _, fast = self._window.delta_over(self.fast_s)
        _, slow = self._window.delta_over(self.slow_s)
        states = {}
        for slo in self.slos:
            good, total = good_total(slo, cum)
            bad_frac = (total - good) / total if total > 0 else 0.0
            budget = 1.0 - bad_frac / (1.0 - slo.target)
            burn_fast, n_fast = self._burn(slo, fast)
            burn_slow, _ = self._burn(slo, slow)
            firing = (
                n_fast > 0
                and burn_fast > self.burn_factor
                and burn_slow > self.burn_factor
            )
            with self._lock:
                self._worst[slo.name] = max(
                    self._worst.get(slo.name, 0.0), burn_fast
                )
                active_since = self._active.get(slo.name)
                start = firing and active_since is None
                # Clear on fast-window recovery (the slow window keeps
                # "burning" long after the incident ends — standard
                # multi-window reset).
                stop = (
                    active_since is not None
                    and burn_fast <= self.burn_factor
                )
                if start:
                    self._active[slo.name] = t
                elif stop:
                    del self._active[slo.name]
            if start:
                payload = {
                    "slo": slo.name, "burn_fast": burn_fast,
                    "fast_s": self.fast_s, "burn_slow": burn_slow,
                    "slow_s": self.slow_s, "budget_remaining": budget,
                }
                if slo.tenant is not None:
                    payload["tenant"] = slo.tenant
                obs.emit("ctrl", "slo_burn_start", payload, logger=log)
                obs.counter(
                    "slo_burn_alerts_total", "burn-rate alert starts"
                ).inc(slo=slo.name)
                with self._lock:
                    self.alerts.append(dict(payload, event="start", t=t))
                self._fire_alert("start", slo, payload)
            elif stop:
                payload = {
                    "slo": slo.name, "active_s": t - active_since,
                    "budget_remaining": budget,
                }
                if slo.tenant is not None:
                    payload["tenant"] = slo.tenant
                obs.emit("ctrl", "slo_burn_stop", payload, logger=log)
                with self._lock:
                    self.alerts.append(dict(payload, event="stop", t=t))
                self._fire_alert("stop", slo, payload)
            self._registry.gauge(
                "slo_error_budget_remaining",
                "fraction of the SLO error budget left (negative = "
                "violated)",
            ).set(budget, slo=slo.name)
            states[slo.name] = {
                "good": good, "total": total,
                "budget_remaining": budget,
                "burn_fast": burn_fast, "burn_slow": burn_slow,
                "firing": start or (active_since is not None and not stop),
            }
        with self._lock:
            self._states = states
        return states

    def _fire_alert(self, event: str, slo: SLO, payload: dict) -> None:
        if self.on_alert is None:
            return
        try:
            self.on_alert(event, slo, payload)
        except Exception:  # noqa: BLE001 - a hook must not stop evaluation
            log.exception("slo on_alert hook failed")

    def replay(self, records: Sequence[dict]) -> dict:
        """Feed every ``metrics_flush`` journal record through
        :meth:`observe` (on the records' wall clock) — synthetic-journal
        tests and post-hoc reports use the live code path."""
        states: dict = {}
        for rec in records:
            if rec.get("kind") != "metrics_flush":
                continue
            snap = (rec.get("payload") or {}).get("snapshot")
            if isinstance(snap, dict):
                states = self.observe(t=rec.get("ts", 0.0), snapshot=snap)
        return states

    def verdicts(self) -> list[dict]:
        """Final per-SLO verdicts: held
        means the whole-run error fraction stayed inside budget."""
        with self._lock:
            states = dict(self._states)
            worst = dict(self._worst)
            alerts = list(self.alerts)
        out = []
        for slo in self.slos:
            st = states.get(slo.name, {})
            budget = st.get("budget_remaining", 1.0)
            out.append({
                "slo": slo.name,
                "kind": slo.kind,
                "target": slo.target,
                "threshold_s": slo.threshold_s,
                "level": slo.level,
                "tenant": slo.tenant,
                "good": st.get("good", 0.0),
                "total": st.get("total", 0.0),
                "budget_remaining": round(budget, 6),
                "worst_burn_fast": round(worst.get(slo.name, 0.0), 3),
                "burn_alerts": sum(
                    1 for a in alerts
                    if a["slo"] == slo.name and a["event"] == "start"
                ),
                "held": budget >= 0.0,
            })
        return out

    # -- loop --------------------------------------------------------------

    def start(self, period_s: float = 1.0) -> "SLOEngine":
        if self._thread is not None:
            return self

        def loop() -> None:
            while not self._stop_event.wait(period_s):
                try:
                    self.observe()
                except Exception:
                    log.exception("slo evaluation failed")

        self._thread = threading.Thread(
            target=loop, name="ctrl-slo", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.observe()  # final evaluation so verdicts cover the tail
