"""Flight recorder: a bounded in-memory ring of recent events.

The port's own copy of ``mx_rcnn_tpu/obs/flight.py`` in the plane's
unconfigured mode (``obs/__init__.py``): every event emitted through the
plane lands in the ring, a fixed-size ``collections.deque``, so the
steady-state cost is one dict append and old entries fall off the back.
The JAX recorder's dump of the ring to a postmortem file under the
configured obs dir, and its crash handler, come with the configured plane
(``obs.configure``), which is not ported yet.
"""

from __future__ import annotations

import collections
import threading

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring.  Thread-safe."""

    def __init__(self, size: int = 512) -> None:
        self._ring: collections.deque[dict] = collections.deque(maxlen=size)
        self._lock = threading.Lock()

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._ring)
