"""Step-boundary preemption handling (port of
``mx_rcnn_tpu/train/preemption.py``).

A spot or preemptible machine gets a SIGTERM and a short grace window.
:class:`PreemptionGuard` turns the signal into a flag that the train loop
reads at its drains: it finishes the step in flight, writes a synchronous
checkpoint and raises :class:`Preempted`, which ``cli/train_cli.py`` maps
to :data:`RESUMABLE_EXIT_CODE` so a supervisor can tell "re-run me with
--resume" from a crash.  SIGINT is handled the same way, and a second
SIGINT raises ``KeyboardInterrupt`` at once.
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("mx_rcnn_tpu_torch")

# EX_TEMPFAIL: "try again later", distinct from 0 (done), 1 (crash) and
# 128+signal (killed).  Supervisors re-invoke with --resume on this code.
RESUMABLE_EXIT_CODE = 75


class Preempted(RuntimeError):
    """Raised by the train loop after a preemption drain: ``step`` is
    checkpointed under ``ckpt_dir`` (the write finished before this)."""

    def __init__(self, step: int, ckpt_dir: str | None = None) -> None:
        super().__init__(f"preempted at step {step}; emergency checkpoint "
                         f"{'in ' + ckpt_dir if ckpt_dir else 'written'}: re-run with --resume")
        self.step = step
        self.ckpt_dir = ckpt_dir


class PreemptionGuard:
    """Context manager: SIGTERM and SIGINT set ``triggered`` instead of
    killing.  Handlers are installed on ``__enter__`` and the previous ones
    restored on ``__exit__``; off the main thread, where signal handlers
    cannot be installed, the guard is an inert flag."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self.triggered = False
        self.signum: int | None = None
        self._previous: dict[int, object] = {}

    def _handle(self, signum, frame) -> None:
        if self.triggered and signum == signal.SIGINT:
            raise KeyboardInterrupt  # a second Ctrl-C: out now, no drain
        self.triggered = True
        self.signum = signum
        log.warning("received %s: draining the step in flight, then writing an emergency "
                    "checkpoint", signal.Signals(signum).name)

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            log.warning("PreemptionGuard off the main thread: signal handlers not installed; "
                        "preemption will NOT drain gracefully")
            return self
        for sig in self.SIGNALS:
            self._previous[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
