"""Tracing and profiling on ``torch.profiler``.

:func:`trace` and :class:`ProfileWindow` are the port of
``mx_rcnn_tpu/utils/profiling.py``'s hooks (``jax.profiler`` there): they
write a Chrome trace (host ops, and the card's kernels when a GPU is
present) of a block or of a window of train steps into a directory, loadable
in Perfetto beside ``obs/report.py``'s span trace.  The rest gives the
device-time breakdowns of the profile entry points (``serve/profile.py``,
``train/profile.py``)."""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import subprocess
import time
from typing import Iterator, Optional

import torch

log = logging.getLogger("mx_rcnn_tpu_torch")

# Kernel-name fragments -> stage; the first match wins.
_STAGES = (
    ("roi_align_fwd", "B1 roi_align kernel"),
    ("roi_align_bwd", "B2 roi_align backward kernel"),
    ("roi_tile_bins", "B2 roi_align backward kernel"),
    ("fused_middle", "B3 fused middle kernel"),
    ("nms_tile_masks", "B4 nms kernel"),
    ("nms_sweep", "B4 nms kernel"),
    ("fprop", "convolutions"),
    ("conv", "convolutions"),
    ("implicit_gemm", "convolutions"),
    ("gemm", "matmuls"),
    ("nvjet", "matmuls"),
    ("cutlass", "matmuls"),
    ("Memcpy HtoD", "host-to-device copies"),
    ("sort", "sorts (top-k, argsort)"),
    ("Sort", "sorts (top-k, argsort)"),
    ("radix", "sorts (top-k, argsort)"),
    ("gather", "gathers and scatters"),
    ("scatter", "gathers and scatters"),
    ("index", "gathers and scatters"),
    ("reduce", "reductions"),
    ("Memcpy", "other copies"),
    ("Memset", "other copies"),
    ("copy", "dtype casts and copies"),
)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(device) -> None:
    """Wait for the card's queued work (JAX's ``block_until_ready``)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# One number a trace in this process, so that a second trace with the
# same tag (a window reopened after a rollback, a second block) is a new
# file, as each start of JAX's profiler is a new run directory.
_exports = itertools.count()


def _export(prof, logdir: str, tag: str) -> None:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{tag}_{os.getpid()}_{next(_exports)}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Host (and, with a GPU present, kernel) trace of the enclosed block
    into ``logdir/trace_block_<pid>_<n>.json`` (no-op when logdir is None);
    the current card's queued work is waited for before the trace stops."""
    if not logdir:
        yield
        return
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        _export(prof, logdir, "block")


class ProfileWindow:
    """Trace a [start, stop) step interval of a training loop into
    ``logdir/trace_step<first traced step>_<pid>_<n>.json``.

    Robust to resume (entering the loop mid-window starts the trace on the
    first step inside it) and to runs that end inside the window (the loop
    calls :meth:`close` on exit; an active trace is stopped exactly once).
    ``sync`` is the loop's device: its queued work is waited for at both
    ends, so that the window holds whole steps.  With a GPU present the
    trace records its kernels too."""

    def __init__(self, logdir: Optional[str], start: int, stop: int) -> None:
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None
        self._first = None

    def step(self, i: int, sync=None) -> None:
        """Call at the top of loop step ``i``."""
        if not self.logdir:
            return
        if self._prof is None and self.start <= i < self.stop:
            _sync(sync)
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
            self._first = i
        elif self._prof is not None and i >= self.stop:
            self.close(sync)

    def close(self, sync=None) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            _sync(sync)
            prof.stop()
            _export(prof, self.logdir, f"step{self._first}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def stage_of(name: str) -> str:
    for frag, stage in _STAGES:
        if frag in name:
            return stage
    return "other elementwise"


def busy_share(intervals, t0, t1) -> float:
    """Share of [t0, t1] covered by the union of the intervals."""
    busy, end = 0.0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return busy / max(t1 - t0, 1e-9)


def traced_breakdown(fn, calls: int = 2) -> dict:
    """Trace ``calls`` calls of ``fn`` (each must end synchronized with the
    card) and return the device time per call by stage and by kernel name
    (largest first), the kernel launches per call and the device-busy share
    of the traced window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        for _ in range(calls):
            fn()
        traced = time.perf_counter() - w0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_stage = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / (1e3 * calls)
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        by_stage[stage_of(e.name)] = by_stage.get(stage_of(e.name), 0.0) + ms
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    start = min(s for s, _ in spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "device_ms_per_call": sum(by_stage.values()),
        "device_busy_share_of_traced_window": busy_share(spans, start, start + traced * 1e6),
        "kernel_launches_per_call": len(kernels) / calls,
        "device_ms_by_stage": dict(sorted(by_stage.items(), key=lambda kv: -kv[1])),
        "device_ms_top_kernels": dict((k[:90], v) for k, v in top),
    }


def entry_ms(call, entries, iters: int = 20) -> float:
    """Device time of the kernels that one ``call()`` of a kernel wrapper
    launches, without the wrapper's host work.  ``entries`` are the ctypes
    C entry points the call may reach (``_build._ENTRIES.values()`` once
    the call has run).  Each of them, when the wrapper calls it with its
    own arguments, is called ``iters`` times more with the same arguments
    between two CUDA events on the current stream, from its ``errcheck``
    hook, so the wrapper's tensors and scratch are still alive; the means
    are summed over the entry points the call reached.  An entry point
    called without arguments is a query, not a launch, and is not timed.
    Returns ms."""
    spans, replaying = [], []

    def replay(rc, fn, args):
        if replaying or not args or rc != 0:
            return rc
        replaying.append(fn)
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            codes = {fn(*args) for _ in range(iters)}
            end.record()
            end.synchronize()
        finally:
            replaying.clear()
        if codes != {0}:
            raise RuntimeError(f"{fn.__name__}: CUDA error codes {codes} in the replays")
        spans.append(start.elapsed_time(end) / iters)
        return rc

    entries = list(entries)
    for fn in entries:
        fn.errcheck = replay
    try:
        call()
    finally:
        for fn in entries:
            del fn.errcheck
    if not spans:
        raise RuntimeError("the call launched no kernel through the given entry points")
    return sum(spans)
