"""The quarantine journal (port of the journal half of
``mx_rcnn_tpu/data/cache.py``).

``quarantine_append`` writes one ``O_APPEND`` ``os.write`` a record, so a
record is either fully present or absent: writers interleave at line
granularity and a crash mid-append tears at most the final line, which
``quarantine_read`` skips.  Records carry a wall-clock and a monotonic
timestamp and a ``reason`` (``io`` | ``annotation``).  The tensor cache
of the JAX module is not ported.
"""

from __future__ import annotations

import json
import os
import time


def quarantine_append(path: str, record: dict) -> None:
    """Append one JSON record crash-safely, with ``ts`` (epoch seconds) and
    ``ts_mono_ns`` (monotonic, for in-run ordering) unless given."""
    rec = dict(record)
    rec.setdefault("ts", round(time.time(), 3))
    rec.setdefault("ts_mono_ns", time.monotonic_ns())
    line = (json.dumps(rec) + "\n").encode()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line)
    finally:
        os.close(fd)


def quarantine_read(path: str) -> list[dict]:
    """All parseable records; a torn trailing line or a corrupt interior
    line is skipped, not fatal."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "rb") as f:
        for line in f:
            try:
                out.append(json.loads(line.decode("utf-8", "replace")))
            except ValueError:
                continue
    return out
