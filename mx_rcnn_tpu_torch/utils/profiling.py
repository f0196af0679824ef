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
