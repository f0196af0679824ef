"""Train the port on the card (counterpart of ``mx_rcnn_tpu/cli/train_cli.py``).

    python -m mx_rcnn_tpu_torch.cli.train_cli --config r50_fpn_coco \
        --set data.dataset=synthetic --steps 5 --workdir runs

Runs ``--steps`` single-device train steps on the synthetic dataset with
random weights from the seed, prints one JSON metrics line per step, and
saves checkpoints under ``<workdir>/<config name>/ckpt`` every
``train.checkpoint_every`` steps and after the last (``--workdir``
defaults to the config's ``workdir``).
``--device`` defaults to the card; without one it raises rather than fall
back to the CPU (``--device cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses

from mx_rcnn_tpu_torch.config import apply_overrides, available_configs, get_config


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="r50_fpn_coco", choices=available_configs())
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override, e.g. model.rpn.loss_impl=compact (repeatable)")
    p.add_argument("--steps", type=int, default=None,
                   help="train steps (default: the schedule's total_steps)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--seed", type=int, default=None, help="override train.seed")
    p.add_argument("--workdir", default=None, help="run directory (checkpoints)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(get_config(args.config), args.set)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=args.seed))
    if args.workdir:
        cfg = dataclasses.replace(cfg, workdir=args.workdir)
    from mx_rcnn_tpu_torch.train.loop import train

    return train(cfg, steps=args.steps, device=args.device, workdir=cfg.workdir)


if __name__ == "__main__":
    main()
