"""Argument plumbing shared by the port's CLIs (port of
``mx_rcnn_tpu/cli/common.py``).

Every CLI takes ``--config <preset>``, dotted ``--set
section.field=value`` overrides, ``--workdir`` and ``-v``, and gets back
one frozen :class:`~mx_rcnn_tpu_torch.config.Config`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from mx_rcnn_tpu_torch.config import Config, apply_overrides, available_configs, get_config


def setup_logging(verbose: bool = False) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
        force=True,
    )


def add_config_args(p: argparse.ArgumentParser, default: str = "r50_fpn_coco") -> None:
    p.add_argument("--config", default=default, choices=available_configs(),
                   help="experiment preset")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY.PATH=VALUE",
                   help="dotted config override, e.g. --set data.root=/data/coco "
                        "--set train.schedule.total_steps=1000 (repeatable)")
    p.add_argument("--workdir", default=None, help="run directory (ckpts, dumps)")
    p.add_argument("-v", "--verbose", action="store_true")


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = get_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if getattr(args, "workdir", None):
        cfg = dataclasses.replace(cfg, workdir=args.workdir)
    return cfg


def default_use_07_metric(cfg: Config) -> bool:
    """The VOC metric's default, shared by eval and reeval: the 11-point
    AP for VOC2007 splits (the reference's choice), the area metric
    everywhere else."""
    return cfg.data.dataset == "voc" and cfg.data.val_split.startswith("2007")


def submission_imageset(cfg: Config) -> str:
    """The imageset token of comp4 det file names: a VOC split is
    ``<year>_<imageset>``, so its imageset part ("comp4_det_test_<cls>.txt");
    another dataset's split as it is."""
    split = cfg.data.val_split
    return split.split("_")[-1] if cfg.data.dataset == "voc" else split
