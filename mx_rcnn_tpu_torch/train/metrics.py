"""Host-side metric accumulation and throughput (port of
``mx_rcnn_tpu/train/metrics.py``).

The six reference metrics are computed on the device by the train step
(``parallel/step.py``) and stay there: the loop keeps each step's dict of
0-d device tensors until a drain, which reads the whole interval back in
one transfer (:func:`host_interval_metrics`).  :class:`Speedometer` gives
images per second between drains, :class:`ScalarWriter` the
``metrics.jsonl`` training curve.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger("mx_rcnn_tpu_torch")


class Speedometer:
    """Samples per second between calls, and a log line a call.  The
    first call after construction has no interval (and its window holds
    the first step's set-up), so it logs the metrics alone and returns
    None."""

    def __init__(self, batch_size: int) -> None:
        self.batch_size = batch_size
        self._tic = time.monotonic()
        self._last_step: Optional[int] = None

    def __call__(self, step: int, metrics: dict) -> Optional[float]:
        parts = ", ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        speed = None
        if self._last_step is None:
            log.info("step %d %s", step, parts)
        else:
            delta = max(step - self._last_step, 1)
            speed = delta * self.batch_size / max(time.monotonic() - self._tic, 1e-9)
            log.info("step %d speed %.2f samples/sec %s", step, speed, parts)
        self._last_step = step
        self._tic = time.monotonic()
        return speed


def host_interval_metrics(pending: list[dict]) -> tuple[dict[str, float], list[dict[str, float]]]:
    """Interval means and per-step host values of ``pending`` (one dict of
    0-d tensors a step, all on one device, the same keys), read back in
    ONE transfer: a single ``torch.stack`` then ``.cpu()``.  ``lr`` reports
    the interval's last value; the other means are taken in float64 on
    the host.  The per-step list is the guardian's input."""
    keys = list(pending[-1])
    table = torch.stack([torch.stack([d[k].float() for k in keys]) for d in pending])
    rows = table.cpu().double().tolist()
    steps = [dict(zip(keys, row)) for row in rows]
    out = {}
    for j, k in enumerate(keys):
        vals = [row[j] for row in rows]
        out[k] = vals[-1] if k == "lr" else sum(vals) / len(vals)
    return out, steps


def host_mean_metrics(pending: list[dict]) -> dict[str, float]:
    """Mean metrics over an interval (see :func:`host_interval_metrics`)."""
    return host_interval_metrics(pending)[0]


class ScalarWriter:
    """Append-only jsonl scalar log, one ``{"step": ..., metric: value}``
    object a log point.

    A crash between a checkpoint and the next flush, or a guardian
    rollback, leaves rows ahead of the restored step; ``resume_step`` (and
    the rollback's :meth:`truncate`) first drops every row with
    ``step > restored_step``, and any torn last line, by an atomic
    rewrite.  A fresh run (``resume=False``) starts the file empty."""

    def __init__(self, path: str, resume: bool = False,
                 resume_step: Optional[int] = None) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        if resume and resume_step is not None:
            self._rewrite_upto(resume_step)
        self._f = open(path, "a" if resume else "w", buffering=1)

    def _rewrite_upto(self, max_step: int) -> None:
        """Atomically drop rows with step > ``max_step`` and torn lines."""
        if not os.path.exists(self._path):
            return
        kept: list[str] = []
        dropped = 0
        with open(self._path) as f:
            for line in f:
                try:
                    step = int(json.loads(line)["step"])
                except (ValueError, KeyError, TypeError):
                    dropped += 1  # a torn partial write
                    continue
                if step <= max_step:
                    kept.append(line if line.endswith("\n") else line + "\n")
                else:
                    dropped += 1
        if not dropped:
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, self._path)
        log.info("metrics log truncated to step %d (%d stale row(s) dropped)", max_step, dropped)

    def truncate(self, max_step: int) -> None:
        """Guardian rollback: keep the rows up to ``max_step`` only."""
        self._f.close()
        self._rewrite_upto(max_step)
        self._f = open(self._path, "a", buffering=1)

    def write(self, step: int, metrics: dict) -> None:
        self._f.write(json.dumps({"step": step, **metrics}) + "\n")

    def close(self) -> None:
        self._f.close()
