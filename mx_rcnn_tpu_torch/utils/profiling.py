"""Device-time breakdowns from ``torch.profiler`` traces, for the
profile entry points (``serve/profile.py``, ``train/profile.py``)."""

from __future__ import annotations

import subprocess
import time

import torch

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
