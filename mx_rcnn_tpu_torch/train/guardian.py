"""NaN guardian: divergence detection and bounded checkpoint rollback
(port of ``mx_rcnn_tpu/train/guardian.py``).

* **Detection** rides the loop's one-transfer-an-interval metrics drain:
  the train step reduces the gradients' global norm and every loss metric
  to one on-device 0/1 scalar (``metrics["nonfinite"]``,
  ``parallel/step.py``) that travels with the metrics the loop reads
  anyway.
* **Rollback**: on detection the loop restores the newest checkpoint at
  or below the last boundary whose interval was finite (restore checks
  every leaf is finite), deletes the newer steps, skips the offending
  data window and retries.  Retries are bounded; past the budget
  :class:`TrainingDiverged` stops the run loudly.
* **Loss-spike warning**: an interval mean loss far above the trailing
  window's mean (a z-score) is logged, without a rollback.

Each decision is a typed event of the observability plane
(``guardian_rollback``, ``guardian_loss_spike``, ``training_diverged``),
journaled when the plane is configured; a divergence also dumps the
flight ring before it raises.
"""

from __future__ import annotations

import collections
import logging
import math
from dataclasses import dataclass
from typing import Optional

from mx_rcnn_tpu_torch import obs

log = logging.getLogger("mx_rcnn_tpu_torch")


class TrainingDiverged(RuntimeError):
    """Non-finite training metrics persisted past the rollback budget."""


@dataclass(frozen=True)
class Rollback:
    """The guardian's verdict at a poisoned drain: ``detect_step`` is the
    boundary whose interval held the first non-finite value."""

    detect_step: int
    reason: str
    attempt: int


class Guardian:
    """Per-run divergence watchdog.  ``observe`` takes each drain's
    interval means and per-step host values and returns a
    :class:`Rollback` for a poisoned interval, None for a clean one."""

    def __init__(self, max_rollbacks: int = 2, spike_zscore: float = 8.0,
                 spike_window: int = 64) -> None:
        self.max_rollbacks = max_rollbacks
        self.spike_zscore = spike_zscore
        self.rollbacks = 0
        self._losses: collections.deque[float] = collections.deque(maxlen=spike_window)

    @staticmethod
    def _poisoned(means: dict, per_step: list[dict]) -> Optional[str]:
        # The on-device reduction also covers the gradient norm, which the
        # metrics do not; the sweep over the means catches a step function
        # that ships no reduction.
        for d in per_step:
            if d.get("nonfinite", 0.0) > 0.0:
                return "on-device finiteness reduction tripped"
        if means.get("nonfinite", 0.0) > 0.0:
            return "on-device finiteness reduction tripped (interval mean)"
        for key, v in sorted(means.items()):
            if not math.isfinite(v):
                return f"interval mean of {key!r} is {v!r}"
        return None

    def observe(self, step: int, means: dict, per_step: list[dict]) -> Optional[Rollback]:
        reason = self._poisoned(means, per_step)
        if reason is not None:
            self.rollbacks += 1
            if self.rollbacks > self.max_rollbacks:
                obs.emit("train", "training_diverged", {
                    "step": step, "reason": reason, "rollbacks": self.max_rollbacks,
                }, logger=log)
                obs.flight_dump("training_diverged")
                raise TrainingDiverged(
                    f"non-finite training metrics at step {step} ({reason}) after "
                    f"{self.max_rollbacks} rollback retr"
                    f"{'y' if self.max_rollbacks == 1 else 'ies'}: the divergence is not "
                    "data-local; lower the lr or inspect the model")
            obs.emit("train", "guardian_rollback", {
                "step": step, "reason": reason, "attempt": self.rollbacks,
                "max_attempts": self.max_rollbacks,
            }, logger=log)
            return Rollback(step, reason, self.rollbacks)
        self._note_loss(step, means)
        return None

    def _note_loss(self, step: int, means: dict) -> None:
        loss = means.get("loss")
        if loss is None:
            return
        n = len(self._losses)
        if n >= 8:
            mean = sum(self._losses) / n
            std = math.sqrt(sum((x - mean) ** 2 for x in self._losses) / n)
            if std > 0.0 and (loss - mean) / std > self.spike_zscore:
                obs.emit("train", "guardian_loss_spike", {
                    "step": step, "loss": float(loss), "sigma": (loss - mean) / std,
                    "mean": mean,
                }, logger=log)
        self._losses.append(float(loss))
