"""Flight recorder: a bounded in-memory ring of recent events + spans,
dumped to a postmortem artifact when something dies.

The port's own copy of ``mx_rcnn_tpu/obs/flight.py``.  Every event
emitted through the plane (configured or not) and every finished span
lands in the ring — a fixed-size ``collections.deque``,
so steady-state cost is one dict append and old entries fall off the
back.  On a trigger (engine watchdog fire, ``engine.kill``, a
preemption's drain, guardian ``TrainingDiverged``, or an unhandled
exception via the installed crash handler) the ring is written out as
``flight_<trigger>_<pid>_<n>.json`` under the configured obs dir: the
last-N-things-that-happened record a human (or ``obs/report.py``)
reads first in a postmortem.

Dumps are best-effort by design: the recorder must never turn a dying
process's last breath into a second crash.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import traceback
from typing import Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring + dump-on-trigger.  Thread-safe."""

    def __init__(self, size: int = 512) -> None:
        self._ring: collections.deque[dict] = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self._dumps = 0
        self.out_dir: Optional[str] = None
        self.run_id: str = "-"

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, trigger: str, extra: Optional[dict] = None
             ) -> Optional[str]:
        """Write the ring to ``flight_<trigger>_<pid>_<n>.json``; returns
        the path, or None when no obs dir is configured (the ring is
        still intact for a later trigger).  Never raises."""
        try:
            out_dir = self.out_dir
            if not out_dir:
                return None
            with self._lock:
                entries = list(self._ring)
                n = self._dumps
                self._dumps += 1
            safe = "".join(
                c if (c.isalnum() or c in "-_") else "_" for c in trigger
            )
            path = os.path.join(
                out_dir, f"flight_{safe}_{os.getpid()}_{n}.json"
            )
            payload = {
                "run_id": self.run_id,
                "trigger": trigger,
                "ts": round(time.time(), 3),
                "ts_mono_ns": time.monotonic_ns(),
                "pid": os.getpid(),
                "entries": entries,
            }
            if extra:
                payload["extra"] = extra
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 - postmortems must not re-crash
            return None

    # -- crash handler -----------------------------------------------------

    def install_crash_handler(self) -> None:
        """Chain onto sys.excepthook + threading.excepthook: an unhandled
        exception dumps the ring (trigger "crash") before the normal
        traceback machinery runs."""
        import sys

        prev_hook = sys.excepthook
        prev_thread_hook = threading.excepthook

        def _dump_exc(exc_type, exc, tb, where: str) -> None:
            self.record({
                "type": "event", "subsystem": "crash",
                "kind": "unhandled_exception",
                "ts": round(time.time(), 3),
                "ts_mono_ns": time.monotonic_ns(),
                "payload": {
                    "where": where,
                    "exc_type": getattr(exc_type, "__name__", str(exc_type)),
                    "message": str(exc),
                    "traceback": "".join(
                        traceback.format_exception(exc_type, exc, tb)
                    )[-4000:],
                },
            })
            self.dump("crash")

        def hook(exc_type, exc, tb):
            _dump_exc(exc_type, exc, tb, "main")
            prev_hook(exc_type, exc, tb)

        def thread_hook(args):
            _dump_exc(
                args.exc_type, args.exc_value, args.exc_traceback,
                getattr(args.thread, "name", "thread"),
            )
            prev_thread_hook(args)

        sys.excepthook = hook
        threading.excepthook = thread_hook
