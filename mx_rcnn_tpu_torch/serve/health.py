"""Engine health: readiness/liveness state machine + stats snapshot.

The port's own copy of ``mx_rcnn_tpu/serve/health.py``, states and
transitions unchanged.

The serving states and their transitions:

    STARTING --warmup ok--> READY <---> DEGRADED --watchdog/hard fail--> DEAD
         \\--warmup fail--> DEAD

STARTING   programs are compiling; not ready, alive.
READY      serving at full quality; ready, alive.
DEGRADED   serving, but the circuit breaker is open or recent requests
           were shed/missed deadlines; ready (still serving!), alive.
DEAD       the watchdog declared a hung device call, warmup failed, or
           the engine was stopped; not ready, not alive — a supervisor
           should replace the process.

``snapshot()`` is the one stats surface: queue depth, in-flight age,
latency percentiles, shed/deadline-miss counters, per-level served
counts, breaker state.  It is cheap (no locks held while formatting) and
safe to poll from a liveness thread.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

STARTING = "starting"
READY = "ready"
DEGRADED = "degraded"
DEAD = "dead"

_TRANSITIONS = {
    STARTING: {READY, DEAD},
    READY: {DEGRADED, DEAD},
    DEGRADED: {READY, DEAD},
    DEAD: set(),
}


class EngineHealth:
    """Thread-safe health state + serving counters for one engine."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        latency_window: int = 256,
        replica_id: Optional[int] = None,
    ) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._state = STARTING
        self._reason = "warming up"
        self._since = clock()
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=latency_window
        )
        self.replica_id = replica_id
        self.shed = 0
        self.deadline_missed = 0
        self.hung = 0
        self.failed = 0
        # Monotonic weight-swap counter: which weights this engine serves.
        # The fleet router and loadgen assert response provenance against
        # it (every served result carries the generation that produced it).
        self.generation = 0
        self.served: collections.Counter[str] = collections.Counter()

    # -- state machine -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def reason(self) -> str:
        with self._lock:
            return self._reason

    def transition(self, new: str, reason: str = "") -> bool:
        """Move to ``new`` if legal; DEAD is absorbing.  Returns whether
        the transition happened (idempotent re-entry returns False)."""
        with self._lock:
            if new == self._state:
                return False
            if new not in _TRANSITIONS[self._state]:
                return False
            self._state = new
            self._reason = reason
            self._since = self._clock()
            return True

    def ready(self) -> bool:
        """Readiness: may traffic be routed here?  DEGRADED still serves."""
        with self._lock:
            return self._state in (READY, DEGRADED)

    def alive(self) -> bool:
        """Liveness: is restarting the process the only fix?  Everything
        except DEAD is alive — a DEGRADED engine recovers on its own."""
        with self._lock:
            return self._state != DEAD

    # -- counters ----------------------------------------------------------

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_deadline_miss(self) -> None:
        with self._lock:
            self.deadline_missed += 1

    def record_failure(self) -> None:
        with self._lock:
            self.failed += 1

    def record_served(self, level: str, latency_s: float) -> None:
        with self._lock:
            self.served[level] += 1
            self._latencies.append(latency_s)

    def record_swap(self, generation: int) -> None:
        """A weight swap completed; ``generation`` must be monotonic."""
        with self._lock:
            if generation < self.generation:
                raise ValueError(
                    f"weight generation moved backwards: "
                    f"{self.generation} -> {generation}"
                )
            self.generation = generation

    # -- snapshot ----------------------------------------------------------

    def _percentile(self, values: list[float], q: float) -> Optional[float]:
        if not values:
            return None
        values = sorted(values)
        idx = min(len(values) - 1, int(round(q * (len(values) - 1))))
        return values[idx]

    def snapshot(self, **extra) -> dict:
        """One JSON-able dict of everything an operator dashboard needs.
        ``extra`` lets the engine merge live gauges (queue depth, in-flight
        age, breaker state) it owns."""
        with self._lock:
            lat = list(self._latencies)
            out = {
                "state": self._state,
                "reason": self._reason,
                "state_age_s": round(self._clock() - self._since, 3),
                "ready": self._state in (READY, DEGRADED),
                "alive": self._state != DEAD,
                "served": dict(self.served),
                "served_total": sum(self.served.values()),
                "shed": self.shed,
                "deadline_missed": self.deadline_missed,
                "failed": self.failed,
                "hung": self.hung,
                "generation": self.generation,
            }
            if self.replica_id is not None:
                out["replica_id"] = self.replica_id
        out["latency_p50_s"] = self._percentile(lat, 0.50)
        out["latency_p90_s"] = self._percentile(lat, 0.90)
        out.update(extra)
        return out
