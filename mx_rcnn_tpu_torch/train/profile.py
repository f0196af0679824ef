"""Where a train step's time goes, on the card.

    python -m mx_rcnn_tpu_torch.train.profile [--steps 10] [--set KEY=VALUE ...]

Builds ``r50_fpn_coco`` (``model.rpn.loss_impl=compact`` unless ``--set``
says otherwise) with random weights from a seed, assembles one batch of
the synthetic set on the 800x1344 canvas and reuses it, so batch assembly
is not timed.  Runs 3 warm-up steps, times ``--steps`` steps on the host
clock (each ends reading its loss back) and traces two more with
``torch.profiler``.  Prints one JSON line: wall ms per step, images per
second, peak memory, the device-busy share of the traced window, and the
device time by stage and by kernel name, largest first.  It needs a card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from mx_rcnn_tpu_torch.utils.profiling import card_line, traced_breakdown


def main() -> None:
    from mx_rcnn_tpu_torch.config import apply_overrides, get_config
    from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
    from mx_rcnn_tpu_torch.data.loader import assemble
    from mx_rcnn_tpu_torch.train.loop import build_all

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="r50_fpn_coco")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override after model.rpn.loss_impl=compact (repeatable)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card = card_line()
    overrides = ["model.rpn.loss_impl=compact", *args.set, f"train.seed={args.seed}"]
    cfg = apply_overrides(get_config(args.config), overrides)
    _, _, state, step_fn, global_batch = build_all(cfg)
    dev = next(state.model.parameters()).device
    ds = SyntheticDataset(image_hw=tuple(cfg.data.image_size),
                          num_classes=cfg.model.num_classes, seed=args.seed)
    batch = assemble([ds.record(i) for i in range(global_batch)], cfg.data, dev)

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        return float(metrics["loss"])

    for _ in range(3):
        one_step()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one_step()
    wall = (time.perf_counter() - t0) / args.steps
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    trace = traced_breakdown(one_step)
    print(json.dumps({
        "card": card, "config": cfg.name, "overrides": overrides, "batch": global_batch,
        "wall_ms_per_step": wall * 1e3, "img_per_s": global_batch / wall,
        "peak_memory_gib": peak, **trace,
    }))


if __name__ == "__main__":
    main()
