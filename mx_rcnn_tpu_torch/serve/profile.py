"""Where a serving call's time goes, on the card.

    python -m mx_rcnn_tpu_torch.serve.profile [--config r50_fpn_coco] [--batch 2]
        [--calls 10] [--level full] [--int8-head] [--int8-network]
        [--small-bucket H,W]

Builds ``--config`` with random weights from a seed (classes 1-4
favoured, so that the postprocess has detections) and
``serve.fused_middle=on``, warms every program of the runner (the config's
canvas; ``--small-bucket`` adds a second, smaller bucket, which the
``small`` level needs; ``--int8-head`` and ``--int8-network`` add the
``full_q8`` and ``full_q8n`` programs), then times ``--calls``
back-to-back micro-batches of ``--batch`` images (random pixels at the
config's short and long side) through the program of ``--level`` (default
``full``), placed as the engine places it (``small`` at the smaller
bucket, ``reduced`` and ``proposals`` at the smallest), on the host clock
(each call ends in a copy of its results to the host), and traces two more
with ``torch.profiler``.  Prints one JSON line: the wall time per call and
per image, the device-busy share of the traced window (union of kernel
intervals over the window), and the device time by stage and by kernel
name, largest first.  It needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mx_rcnn_tpu_torch.utils.profiling import card_line, traced_breakdown


def main() -> None:
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.serve.engine import DetectorRunner, level_program
    from mx_rcnn_tpu_torch.weights import init_variables

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="r50_fpn_coco")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--level", default="full",
                    help="full, small, full_q8, full_q8n, reduced or proposals")
    ap.add_argument("--int8-head", action="store_true", help="add the full_q8 programs")
    ap.add_argument("--int8-network", action="store_true", help="add the full_q8n programs")
    ap.add_argument("--small-bucket", default=None,
                    help="H,W of a second, smaller bucket (the small level's)")
    args = ap.parse_args()

    card = card_line()
    cfg = apply_overrides(get_config(args.config), ["serve.fused_middle=on"])
    variables = init_variables(cfg.model, torch.Generator().manual_seed(args.seed))
    variables["box_head.cls_score.bias"][1:5] = 4.0
    buckets = [tuple(cfg.data.image_size)]
    if args.small_bucket:
        buckets.append(tuple(int(x) for x in args.small_bucket.split(",")))
    runner = DetectorRunner(cfg, variables, buckets=buckets, batch_size=args.batch,
                            int8_head=args.int8_head, int8_network=args.int8_network)
    if args.level not in runner.levels():
        ap.error(f"--level {args.level} is not among this runner's levels {runner.levels()}")
    runner.warmup()
    rng = np.random.RandomState(args.seed)
    short, long = cfg.data.short_side, cfg.data.max_side
    images = [rng.uniform(0, 255, (short, long, 3)).astype(np.float32)
              for _ in range(args.batch)]
    base = runner.pick_bucket(short, long)
    mode, bucket = level_program(runner, args.level, base)
    runner.run(mode, bucket, images)

    t0 = time.perf_counter()
    for _ in range(args.calls):
        runner.run(mode, bucket, images)
    wall = (time.perf_counter() - t0) / args.calls

    trace = traced_breakdown(lambda: runner.run(mode, bucket, images))
    print(json.dumps({
        "card": card, "config": cfg.name, "level": args.level, "mode": mode,
        "batch": args.batch, "bucket": list(bucket),
        "wall_ms_per_call": wall * 1e3, "wall_ms_per_image": wall * 1e3 / args.batch,
        "img_per_s": args.batch / wall, **trace,
    }))


if __name__ == "__main__":
    main()
