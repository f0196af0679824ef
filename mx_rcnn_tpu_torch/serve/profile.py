"""Where a serving call's time goes, on the card.

    python -m mx_rcnn_tpu_torch.serve.profile [--batch 2] [--calls 10]

Builds ``r50_fpn_coco`` with random weights from a seed and
``serve.fused_middle=on``, warms the ``full`` program on the 800x1344
bucket, then times ``--calls`` back-to-back micro-batches of ``--batch``
images on the host clock (each call ends in a copy of its results to the
host) and traces two more with ``torch.profiler``.  Prints one JSON line:
the wall time per call and per image, the device-busy share of the traced
window (union of kernel intervals over the window), and the device time
by stage and by kernel name, largest first.  It needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# Kernel-name fragments -> stage; the first match wins.
_STAGES = (
    ("roi_align_fwd", "B1 roi_align kernel"),
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


def _stage(name: str) -> str:
    for frag, stage in _STAGES:
        if frag in name:
            return stage
    return "other elementwise"


def _busy_share(intervals, t0, t1) -> float:
    busy, end = 0.0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return busy / max(t1 - t0, 1e-9)


def main() -> None:
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner
    from mx_rcnn_tpu_torch.weights import init_variables

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = apply_overrides(get_config("r50_fpn_coco"), ["serve.fused_middle=on"])
    variables = init_variables(cfg.model, torch.Generator().manual_seed(args.seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    runner = DetectorRunner(cfg, variables, batch_size=args.batch, with_proposals=False)
    runner.warmup()
    rng = np.random.RandomState(args.seed)
    images = [rng.uniform(0, 255, (800, 1333, 3)).astype(np.float32)
              for _ in range(args.batch)]
    bucket = runner.buckets[0]
    runner.run("full", bucket, images)

    t0 = time.perf_counter()
    for _ in range(args.calls):
        runner.run("full", bucket, images)
    wall = (time.perf_counter() - t0) / args.calls

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        for _ in range(2):
            runner.run("full", bucket, images)
        traced = time.perf_counter() - w0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_stage = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 2e3
        by_stage[_stage(e.name)] = by_stage.get(_stage(e.name), 0.0) + us / 2e3
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = _busy_share(spans, min(s for s, _ in spans), min(s for s, _ in spans) + traced * 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "card": card, "batch": args.batch, "bucket": list(bucket),
        "wall_ms_per_call": wall * 1e3, "wall_ms_per_image": wall * 1e3 / args.batch,
        "img_per_s": args.batch / wall,
        "device_ms_per_call": sum(by_stage.values()),
        "device_busy_share_of_traced_window": busy,
        "kernel_launches_per_call": len(kernels) / 2,
        "device_ms_by_stage": dict(sorted(by_stage.items(), key=lambda kv: -kv[1])),
        "device_ms_top_kernels": dict((k[:90], v) for k, v in top),
    }))


if __name__ == "__main__":
    main()
