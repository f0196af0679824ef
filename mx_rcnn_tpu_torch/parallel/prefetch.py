"""Input-stall accounting (the synchronous form of
``mx_rcnn_tpu/parallel/prefetch.py``).

The port assembles each batch in the train loop's own thread: the loader
decodes, flips and uploads the uint8 pixels, then letterboxes them on the
card.  So every ``next(loader)`` blocks the loop, and its whole time is
the data stall that :class:`PrefetchStats` meters (``data_stall_ms`` in
the loop's log).  The background host thread, pinned buffers and the
copy stream of the JAX module are not ported.
"""

from __future__ import annotations

import time
from typing import Iterator


class PrefetchStats:
    """Time the consumer spent blocked waiting for batches; ``take()``
    returns it and resets, so callers meter an interval at a time."""

    def __init__(self) -> None:
        self.stall_s = 0.0
        self.batches = 0

    def add(self, stall_s: float) -> None:
        self.stall_s += stall_s
        self.batches += 1

    def take(self) -> tuple[float, int]:
        """(accumulated stall seconds, batches) since the last take."""
        out = (self.stall_s, self.batches)
        self.stall_s = 0.0
        self.batches = 0
        return out


def _timed_pulls(it: Iterator, stats: PrefetchStats) -> Iterator:
    """Every pull is synchronous, so the whole ``next(it)`` is stall."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        stats.add(time.perf_counter() - t0)
        yield item
