"""Crash-safe typed event journal (JSONL, one ``write(2)`` per record).

The port's own copy of ``mx_rcnn_tpu/obs/journal.py``.  The journal is
the one durable record of a run's lifecycle: every checkpoint
save/restore, guardian rollback, preemption, worker death, cache
quarantine, engine death and breaker flip lands here as ONE appended
line.  The write discipline is
``quarantine_append``'s from ``data/cache.py``:

* the fd is opened ``O_WRONLY|O_CREAT|O_APPEND`` and each record is a
  SINGLE ``os.write`` of one newline-terminated JSON line — on a crash
  (SIGKILL included) at most the final line is torn, never an earlier
  one;
* the reader (:func:`read_journal`) skips unparseable lines, so a torn
  tail or a foreign line degrades to "one record lost", not "journal
  unreadable".

Records carry ``run_id``, wall-clock ``ts`` (epoch seconds, for
cross-process ordering), ``ts_mono_ns`` (monotonic, for intra-process
ordering and durations), a per-writer ``seq`` and ``pid``.  Multiple
processes may append to the same file: ``O_APPEND`` makes each line
atomic at these sizes on every filesystem we run on.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, Optional

__all__ = ["Journal", "read_journal"]


class Journal:
    """Append-only JSONL writer; thread-safe; crash-tears at most 1 line."""

    def __init__(self, path: str, run_id: str) -> None:
        self.path = path
        self.run_id = run_id
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd: Optional[int] = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._lock = threading.Lock()
        self._seq = 0

    def write(self, record: dict) -> None:
        """Append one record.  Stamps run_id/ts/ts_mono_ns/seq/pid unless
        the caller already set them (replayed records keep their stamps)."""
        rec = dict(record)
        rec.setdefault("run_id", self.run_id)
        rec.setdefault("ts", round(time.time(), 3))
        rec.setdefault("ts_mono_ns", time.monotonic_ns())
        rec.setdefault("pid", os.getpid())
        with self._lock:
            if self._fd is None:
                return
            rec.setdefault("seq", self._seq)
            self._seq += 1
            line = json.dumps(rec, sort_keys=True, default=str) + "\n"
            os.write(self._fd, line.encode("utf-8"))

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _iter_lines(path: str) -> Iterator[str]:
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            yield from f
    except OSError:
        return


def read_journal(path: str) -> list[dict]:
    """Read every parseable record; torn/corrupt lines are skipped (the
    crash-safety contract: a kill mid-write loses at most that line)."""
    out: list[dict] = []
    for line in _iter_lines(path):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out
