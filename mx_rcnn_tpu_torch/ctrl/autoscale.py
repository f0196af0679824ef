"""SLO-driven autoscaler: queue/p99/shed pressure -> fleet resizes.

The port's own copy of ``mx_rcnn_tpu/ctrl/autoscale.py``: the policy,
the dwell and cooldowns and the journaled decisions are the JAX
package's.

The policy layer is pure (:func:`desired_action` over immutable
:class:`ScaleSignals` — unit-testable without a fleet); the
:class:`Autoscaler` loop reads signals from ``FleetRouter.stats()`` and
the metrics registry, then drives the dynamic-fleet API:
``fleet.add_replica()`` on pressure, ``fleet.retire_replica(rid)`` when
the fleet has been comfortable long enough.

Asymmetry is deliberate and mirrors ``serve/degrade.py``'s
``HysteresisPlanner``: **scale-up is immediate** (pressure is never
absorbed — one evaluation over threshold adds capacity, gated only by a
cooldown so a build-in-progress isn't doubled), while **scale-down
needs dwell** (``down_dwell`` consecutive comfortable evaluations plus
a cooldown), so the fleet never flaps around a load edge.

Every resize decision is journaled (``fleet_scale_up`` /
``fleet_scale_down`` typed events) WITH its input signals, so
``obs/report.py`` can reconstruct *why* the fleet resized from
the journal alone.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.ctrl.slo import merged_percentile
from mx_rcnn_tpu_torch.obs.metrics import Registry, SnapshotWindow
from mx_rcnn_tpu_torch.serve.router import DEGRADED, QUARANTINED, READY

log = logging.getLogger("mx_rcnn_tpu_torch.ctrl")

__all__ = ["ScaleSignals", "ScalePolicy", "desired_action", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """One evaluation's inputs, all read at the same instant."""

    routable: int          # replicas a request can land on now
    building: int          # quarantined slots with capacity imminent
    mean_load: float       # mean inflight+queue per routable replica
    queue_depth: int       # total queued across routable replicas
    shed_rate: float       # fleet sheds per second over the window
    p99_s: Optional[float]  # windowed p99 latency (None = no data)
    # Pod-wide mean load across live hosts, aggregated from gossip
    # (JAX serve/gossip.py GossipNode.aggregate(); not ported).  None on a single-host
    # deployment — every decision then reads local signals only.
    pod_mean_load: Optional[float] = None

    def as_payload(self) -> dict:
        p = dataclasses.asdict(self)
        p["mean_load"] = round(p["mean_load"], 3)
        p["shed_rate"] = round(p["shed_rate"], 3)
        if p["p99_s"] is not None:
            p["p99_s"] = round(p["p99_s"], 4)
        if p["pod_mean_load"] is not None:
            p["pod_mean_load"] = round(p["pod_mean_load"], 3)
        return p


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Thresholds + hysteresis knobs (cfg.ctrl.*)."""

    min_replicas: int = 1
    max_replicas: int = 8
    load_high: float = 4.0
    load_low: float = 0.5
    shed_high: float = 0.0      # sheds/s strictly above this is pressure
    p99_high_s: float = 0.0     # 0 disables the latency signal
    down_dwell: int = 3
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 15.0

    @classmethod
    def from_config(cls, ctrl_cfg) -> "ScalePolicy":
        return cls(
            min_replicas=ctrl_cfg.min_replicas,
            max_replicas=ctrl_cfg.max_replicas,
            load_high=ctrl_cfg.load_high,
            load_low=ctrl_cfg.load_low,
            shed_high=ctrl_cfg.shed_high,
            p99_high_s=ctrl_cfg.p99_high_s,
            down_dwell=ctrl_cfg.down_dwell,
            up_cooldown_s=ctrl_cfg.up_cooldown_s,
            down_cooldown_s=ctrl_cfg.down_cooldown_s,
        )


def desired_action(sig: ScaleSignals,
                   pol: ScalePolicy) -> tuple[str, str]:
    """("up"|"down"|"hold", reason).  Pure — dwell/cooldown gating is
    the loop's job; this only reads the instant."""
    size = sig.routable + sig.building
    pressure = []
    if sig.mean_load > pol.load_high:
        pressure.append(
            f"mean load {sig.mean_load:.2f} > {pol.load_high:g}"
        )
    if sig.shed_rate > pol.shed_high:
        pressure.append(
            f"shed rate {sig.shed_rate:.2f}/s > {pol.shed_high:g}/s"
        )
    if pol.p99_high_s > 0 and sig.p99_s is not None \
            and sig.p99_s > pol.p99_high_s:
        pressure.append(f"p99 {sig.p99_s:.3f}s > {pol.p99_high_s:g}s")
    if sig.pod_mean_load is not None \
            and sig.pod_mean_load > pol.load_high:
        pressure.append(
            f"pod mean load {sig.pod_mean_load:.2f} > {pol.load_high:g}"
        )
    if pressure:
        if size >= pol.max_replicas:
            return "hold", (
                f"pressure ({'; '.join(pressure)}) but at "
                f"max_replicas={pol.max_replicas}"
            )
        return "up", "; ".join(pressure)
    comfortable = (
        sig.mean_load < pol.load_low
        and sig.shed_rate <= pol.shed_high
        and (
            pol.p99_high_s <= 0 or sig.p99_s is None
            or sig.p99_s <= pol.p99_high_s
        )
        # A host never scales down while the pod as a whole is hot:
        # gossip says peers are loaded, so this host's comfort is
        # about to end (the gateway rebalances toward it).
        and (
            sig.pod_mean_load is None
            or sig.pod_mean_load < pol.load_low
        )
    )
    if comfortable and sig.building == 0 \
            and sig.routable > pol.min_replicas:
        return "down", (
            f"mean load {sig.mean_load:.2f} < {pol.load_low:g}, "
            f"no shed"
        )
    return "hold", "within band"


class Autoscaler:
    """Policy loop over one fleet.  ``step()`` is one evaluation (tests
    drive it directly with a fake clock); ``start(period_s)`` runs it on
    a daemon thread."""

    def __init__(
        self,
        fleet,
        policy: ScalePolicy = ScalePolicy(),
        *,
        registry: Optional[Registry] = None,
        p99_window_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        pod_view: Optional[Callable[[], dict]] = None,
    ) -> None:
        self.fleet = fleet
        self.policy = policy
        # ``pod_view`` returns a gossip aggregate dict (JAX serve/gossip.py,
        # GossipNode.aggregate) so a host scales on POD pressure, not
        # just its own — None keeps single-host behaviour bit-for-bit.
        self.pod_view = pod_view
        self._clock = clock
        self._registry = registry if registry is not None else obs.registry()
        self._window = SnapshotWindow(
            self._registry, horizon_s=max(p99_window_s * 4, 120.0)
        )
        self.p99_window_s = p99_window_s
        self._lock = threading.Lock()
        self._down_streak = 0
        self._last_up = -float("inf")
        self._last_down = -float("inf")
        self._last_shed: Optional[tuple[float, int]] = None
        self.decisions: list[dict] = []  # resize timeline
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -----------------------------------------------------------

    def signals(self, now: Optional[float] = None) -> ScaleSignals:
        now = self._clock() if now is None else now
        stats = self.fleet.stats()
        routable = building = 0
        load = queue = 0
        for rep in stats["replica"]:
            if rep["state"] in (READY, DEGRADED):
                routable += 1
                eng = rep.get("engine") or {}
                q = int(eng.get("queue_depth", 0))
                load += rep["inflight"] + q
                queue += q
            elif rep["state"] == QUARANTINED:
                building += 1
        shed = int(stats.get("shed", 0))
        with self._lock:
            last = self._last_shed
            self._last_shed = (now, shed)
        shed_rate = 0.0
        if last is not None and now > last[0]:
            shed_rate = max(0, shed - last[1]) / (now - last[0])
        _, delta = self._window.delta_over(self.p99_window_s)
        p99 = merged_percentile(delta, 0.99) if delta else None
        if p99 is not None and p99 == float("inf"):
            p99 = None  # beyond the last bucket: no usable estimate
        pod_mean = None
        if self.pod_view is not None:
            try:
                agg = self.pod_view() or {}
                if int(agg.get("hosts", 0)) > 1:
                    pod_mean = float(agg.get("mean_load", 0.0))
            except Exception:  # noqa: BLE001 - gossip is advisory
                log.exception("autoscaler: pod_view failed")
        return ScaleSignals(
            routable=routable,
            building=building,
            mean_load=load / routable if routable else 0.0,
            queue_depth=queue,
            shed_rate=shed_rate,
            p99_s=p99,
            pod_mean_load=pod_mean,
        )

    # -- one evaluation ----------------------------------------------------

    def step(self, now: Optional[float] = None) -> dict:
        now = self._clock() if now is None else now
        self._window.observe(now)
        sig = self.signals(now)
        pol = self.policy
        action, reason = desired_action(sig, pol)
        size = sig.routable + sig.building
        rec = {
            "t": now, "action": action, "reason": reason, "size": size,
            "signals": sig.as_payload(),
        }
        if action == "up":
            with self._lock:
                self._down_streak = 0
                in_cooldown = now - self._last_up < pol.up_cooldown_s
                if not in_cooldown:
                    self._last_up = now
            if in_cooldown:
                rec["action"] = "hold"
                rec["reason"] = f"up-cooldown ({reason})"
            else:
                try:
                    rid = self.fleet.add_replica()
                except Exception as e:  # noqa: BLE001 - keep looping
                    log.exception("autoscaler: add_replica failed")
                    rec["action"], rec["error"] = "hold", str(e)
                else:
                    rec.update(replica=rid, target=size + 1)
                    obs.emit("ctrl", "fleet_scale_up", {
                        "size": size, "target": size + 1,
                        "reason": reason, "replica": rid,
                        "signals": sig.as_payload(),
                    }, logger=log)
                    obs.counter(
                        "ctrl_scale_decisions_total", "fleet resizes"
                    ).inc(direction="up")
        elif action == "down":
            with self._lock:
                self._down_streak += 1
                streak = self._down_streak
                ready = (
                    streak >= pol.down_dwell
                    and now - self._last_down >= pol.down_cooldown_s
                    and now - self._last_up >= pol.down_cooldown_s
                )
                if ready:
                    self._down_streak = 0
                    self._last_down = now
            rec["dwell"] = streak
            if not ready:
                rec["action"] = "hold"
                rec["reason"] = (
                    f"down-dwell {streak}/{pol.down_dwell} ({reason})"
                )
            else:
                victim = self._pick_victim()
                if victim is None:
                    rec["action"] = "hold"
                    rec["reason"] = "no retirable replica"
                else:
                    obs.emit("ctrl", "fleet_scale_down", {
                        "size": size, "target": size - 1,
                        "dwell": streak or pol.down_dwell,
                        "reason": reason, "replica": victim,
                        "signals": sig.as_payload(),
                    }, logger=log)
                    obs.counter(
                        "ctrl_scale_decisions_total", "fleet resizes"
                    ).inc(direction="down")
                    try:
                        clean = self.fleet.retire_replica(
                            victim, reason="autoscaler scale-down"
                        )
                    except Exception as e:  # noqa: BLE001 - keep looping
                        log.exception("autoscaler: retire failed")
                        rec["error"] = str(e)
                    else:
                        rec.update(
                            replica=victim, target=size - 1, clean=clean
                        )
        else:
            with self._lock:
                self._down_streak = 0
        self._registry.gauge(
            "ctrl_fleet_size", "replicas in rotation or building"
        ).set(size)
        if rec["action"] in ("up", "down"):
            with self._lock:
                self.decisions.append(rec)
        return rec

    def _pick_victim(self) -> Optional[int]:
        """Newest (highest-rid) routable replica — deterministic, and
        the one whose device slot was claimed last."""
        rids = [
            rep["rid"] for rep in self.fleet.stats()["replica"]
            if rep["state"] in (READY, DEGRADED)
        ]
        if len(rids) <= self.policy.min_replicas:
            return None
        return max(rids)

    def resize_timeline(self) -> list[dict]:
        with self._lock:
            return list(self.decisions)

    # -- loop --------------------------------------------------------------

    def start(self, period_s: float = 1.0) -> "Autoscaler":
        if self._thread is not None:
            return self

        def loop() -> None:
            while not self._stop_event.wait(period_s):
                try:
                    self.step()
                except Exception:
                    log.exception("autoscaler step failed")

        self._thread = threading.Thread(
            target=loop, name="ctrl-autoscale", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            # A retire drain can hold a step for its full timeout.
            self._thread.join(90.0)
            self._thread = None
