"""Graceful degradation policy: quality ladder + circuit breaker.

The port's own copy of ``mx_rcnn_tpu/serve/degrade.py``: the ladder, its
order and every decision are the JAX package's (the tests hold them
decision for decision).

Serving keeps a small set of pre-compiled programs (serve/engine.py) at
decreasing cost: the full detector at each resolution bucket, a
reduced-``max_detections`` variant, and an RPN-proposals-only variant.
Under pressure — a request deadline the full program's observed latency
cannot meet, or a circuit breaker opened by repeated full-path failures —
requests step DOWN this ladder instead of timing out or queueing forever:

    full  >  small (full quality at a smaller resolution bucket)
          >  full_q8 (int8/bf16 box head — serve/quantize.py; near-full
                      quality, cheaper head; present when the runner was
                      built with ``int8_head=True``)
          >  full_q8n (int8 whole network; ``int8_network=True``)
          >  reduced (fewer max detections)
          >  proposals (RPN boxes only, class-agnostic)

Everything here is pure policy over injected clocks and observed latency
estimates; the engine owns the threads and the device.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Mapping, Optional, Sequence

from mx_rcnn_tpu_torch import obs

# Quality-ordered serving levels, best first.  ``small`` reuses the FULL
# program of a smaller resolution bucket; ``full_q8`` (int8 box head),
# ``full_q8n`` (int8 whole network — cheaper, noisier), ``reduced`` and
# ``proposals`` are distinct programs (engine warmup runs them all up
# front, so degrading never pays a first call mid-incident).
LEVELS = ("full", "small", "full_q8", "full_q8n", "reduced", "proposals")

# Levels that run the full-quality pipeline; the circuit breaker guards
# these (a failing/overrunning full path should stop being probed at
# either resolution until it recovers).
FULL_QUALITY_LEVELS = frozenset({"full", "small"})


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probes.

    closed     normal operation; ``failure_threshold`` consecutive
               failures trip it open.
    open       the full-quality path is not attempted for ``cooldown``
               seconds; requests serve degraded.
    half-open  after the cooldown ONE request is allowed through as a
               probe: success closes the breaker, failure re-opens it
               for another cooldown.

    Thread-safe; the engine's worker calls ``allow_full`` when planning a
    request and reports the outcome with ``record_success`` /
    ``record_failure``.  ``cancel_probe`` returns an unused probe (the
    planner may consume one and then be forced to degrade anyway, e.g. by
    a tight deadline — that must not count as a probe outcome).
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self.trips = 0  # total times the breaker opened (stats)

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown:
            return "half_open"
        return "open"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow_full(self) -> bool:
        """May this request take a full-quality level?  In half-open state
        this CONSUMES the single probe slot."""
        with self._lock:
            s = self._state_locked()
            if s == "closed":
                return True
            if s == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def cancel_probe(self) -> None:
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        closed_from: Optional[str] = None
        with self._lock:
            self._consecutive = 0
            if self._opened_at is not None:
                # A success while open can only be the half-open probe.
                closed_from = self._state_locked()
                self._opened_at = None
            self._probing = False
        if closed_from is not None:
            obs.emit("serve", "breaker_transition", {
                "level": "full", "old_state": closed_from,
                "new_state": "closed",
            })

    def record_failure(self) -> None:
        opened_from: Optional[str] = None
        with self._lock:
            self._consecutive += 1
            if self._probing or self._consecutive >= self.failure_threshold:
                if self._opened_at is None or self._probing:
                    self.trips += 1
                    opened_from = self._state_locked()
                self._opened_at = self._clock()
                self._consecutive = 0
                self._probing = False
        if opened_from is not None:
            obs.emit("serve", "breaker_transition", {
                "level": "full", "old_state": opened_from,
                "new_state": "open",
            })


def plan_level(
    remaining: Optional[float],
    estimates: Mapping[str, float],
    full_allowed: bool,
    available: Sequence[str],
    headroom: float = 1.25,
) -> str:
    """Pick the serving level for one request.

    Args:
      remaining: seconds until the request's deadline (None = no deadline).
      estimates: observed latency estimate per level (seconds); a level
        with no estimate yet is assumed to fit (first requests must not
        degrade on zero information).
      full_allowed: circuit-breaker verdict for the full-quality path.
      available: subset of :data:`LEVELS` the engine actually compiled
        (e.g. ``small`` is absent with a single resolution bucket).
      headroom: a level is deemed to fit when ``estimate * headroom <=
        remaining`` — the margin absorbs queueing jitter.

    Returns the best available level that fits the deadline; if nothing
    fits, the cheapest available level (serving SOMETHING cheap beats a
    guaranteed deadline miss at a better level).
    """
    candidates = [lvl for lvl in LEVELS if lvl in available]
    if not candidates:
        raise ValueError("no serving levels available")
    if not full_allowed:
        candidates = [
            lvl for lvl in candidates if lvl not in FULL_QUALITY_LEVELS
        ] or candidates[-1:]
    if remaining is None:
        return candidates[0]
    for lvl in candidates:
        est = estimates.get(lvl)
        if est is None or est * headroom <= remaining:
            return lvl
    return candidates[-1]


class HysteresisPlanner:
    """Stateful :func:`plan_level` wrapper that damps upgrade thrash.

    A replica sitting at the boundary between two levels (e.g. ``full``
    vs ``full_q8`` when the full estimate hovers around the deadline)
    would otherwise alternate program families request-by-request —
    churning micro-batch grouping and making latency bimodal.  Policy:

    * **Downgrades are immediate** — pressure is never absorbed.
    * **Upgrades need margin and dwell** — moving to a better level
      requires ``up_dwell`` consecutive plans where that level fits the
      deadline with ``up_margin`` extra headroom (``estimate * headroom
      * up_margin <= remaining``); a single borderline reading resets
      the streak.  Requests without a deadline count toward the dwell
      (no pressure signal), so a cleared incident still recovers.

    Thread-safe; one instance per engine (the engine's worker is the
    only planner, but ``stats`` readers may race it).
    """

    def __init__(
        self,
        headroom: float = 1.25,
        up_margin: float = 1.5,
        up_dwell: int = 3,
    ) -> None:
        if up_dwell < 1:
            raise ValueError("up_dwell must be >= 1")
        self.headroom = headroom
        self.up_margin = up_margin
        self.up_dwell = up_dwell
        self._lock = threading.Lock()
        self._level: Optional[str] = None
        self._streak = 0

    @property
    def level(self) -> Optional[str]:
        with self._lock:
            return self._level

    def plan(
        self,
        remaining: Optional[float],
        estimates: Mapping[str, float],
        full_allowed: bool,
        available: Sequence[str],
    ) -> str:
        target = plan_level(
            remaining, estimates, full_allowed, available,
            headroom=self.headroom,
        )
        moved: Optional[tuple[str, str]] = None
        try:
            with self._lock:
                current = self._level
                if current is None or current not in available:
                    self._level, self._streak = target, 0
                    return target
                if LEVELS.index(target) >= LEVELS.index(current):
                    # Same or worse quality: follow plan_level immediately.
                    self._level, self._streak = target, 0
                    if target != current:
                        moved = (current, target)
                    return target
                # Upgrade candidate: count margin-clean plans before moving.
                est = estimates.get(target)
                comfortable = (
                    remaining is None
                    or est is None
                    or est * self.headroom * self.up_margin <= remaining
                )
                self._streak = self._streak + 1 if comfortable else 0
                if self._streak >= self.up_dwell:
                    self._level, self._streak = target, 0
                    moved = (current, target)
                    return target
                return current
        finally:
            if moved is not None:
                obs.emit("serve", "ladder_transition", {
                    "old_level": moved[0], "new_level": moved[1],
                })


class LatencyEstimator:
    """Per-level EWMA of observed serving latency (seconds)."""

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = alpha
        self._est: dict[str, float] = {}
        self._lock = threading.Lock()

    def observe(self, level: str, seconds: float) -> None:
        with self._lock:
            prev = self._est.get(level)
            self._est[level] = (
                seconds
                if prev is None
                else (1 - self.alpha) * prev + self.alpha * seconds
            )

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._est)
