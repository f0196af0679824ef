"""Evaluate the port on the card (counterpart of ``mx_rcnn_tpu/cli/eval_cli.py``).

    python -m mx_rcnn_tpu_torch.cli.eval_cli --config r50_fpn_coco \\
        --set data.dataset=synthetic --ckpt runs/r50_fpn_coco/ckpt

Restores a checkpoint the port's trainer wrote (the newest step, walking
back past a broken one, or ``--step``), runs ``forward_inference`` over
the config's val split, ``test.per_device_batch`` images a call, scores
the detections with the COCO evaluator (the VOC one for
``data.dataset=voc``) and prints the metrics dict, one ``name = value``
line each.  ``--device`` defaults to the card; without one it raises
rather than fall back to the CPU (``--device cpu`` asks for the CPU).
Not ported: sharded and resumable evaluation, ``--proposals`` and
``--from-proposals``, ``--dump-coco`` and ``--dump-voc``, ``--vis``.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

from mx_rcnn_tpu_torch.config import Config, apply_overrides, available_configs, get_config


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="r50_fpn_coco", choices=available_configs())
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override, e.g. data.dataset=synthetic (repeatable)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (default: <workdir>/<config name>/ckpt)")
    p.add_argument("--step", type=int, default=None, help="checkpoint step")
    p.add_argument("--dump", default=None, help="write the detections here (json)")
    p.add_argument("--limit", type=int, default=None, metavar="N",
                   help="evaluate only the first N images")
    p.add_argument("--use-07-metric", action=argparse.BooleanOptionalAction, default=None,
                   help="VOC 11-point AP (default: on for VOC2007 splits)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def default_use_07_metric(cfg: Config) -> bool:
    """The 11-point AP for VOC2007 splits (the reference's choice), the
    area metric everywhere else."""
    return cfg.data.dataset == "voc" and cfg.data.val_split.startswith("2007")


def _eval_loader(cfg: Config, batch_size: int, device, limit: Optional[int] = None):
    """-> (roidb, batches): the val split, cut to its first ``limit``
    images (the metric's roidb too, so absent images do not score as
    misses), and its eval batches on ``device``."""
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import eval_batches

    roidb = build_dataset(cfg.data, train=False).roidb()
    if limit is not None:
        roidb = roidb[:limit]
    if not roidb:
        raise ValueError("empty eval roidb")
    return roidb, eval_batches(roidb, cfg.data, batch_size, device)


def _restored_state(cfg: Config, ckpt_dir: Optional[str], step: Optional[int], device):
    """A train state built for ``cfg`` on ``device`` and restored from
    ``ckpt_dir`` (default ``<workdir>/<name>/ckpt``)."""
    from mx_rcnn_tpu_torch.train.checkpoint import restore_checkpoint
    from mx_rcnn_tpu_torch.train.loop import build_all, checkpoint_dir

    _, _, state, _, _ = build_all(cfg, device)
    return restore_checkpoint(ckpt_dir or checkpoint_dir(cfg), state, step=step)


def run_eval(cfg: Config, state=None, ckpt_dir: Optional[str] = None, step: Optional[int] = None,
             dump_path: Optional[str] = None, use_07_metric: Optional[bool] = None,
             limit: Optional[int] = None, device=None,
             progress: Optional[Callable[[int], None]] = None) -> dict:
    """Evaluate ``state`` (a train state), or the checkpoint restored from
    ``ckpt_dir``, on the config's val split; returns the metrics dict.
    ``progress`` gets the count of images done after each one."""
    from mx_rcnn_tpu_torch.data.datasets import VOC_CLASSES
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.evalutil.pred_eval import pred_eval
    from mx_rcnn_tpu_torch.parallel.step import eval_variables, make_eval_step
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if use_07_metric is None:
        use_07_metric = default_use_07_metric(cfg)
    if state is None:
        state = _restored_state(cfg, ckpt_dir, step, dev)
    model = TwoStageDetector(cfg.model, device=dev)
    model.load_state_dict(eval_variables(state))
    model.eval()
    eval_step = make_eval_step(pixel_stats=(cfg.data.pixel_mean, cfg.data.pixel_std))
    roidb, batches = _eval_loader(cfg, max(cfg.model.test.per_device_batch, 1), dev, limit)
    style = "voc" if cfg.data.dataset == "voc" else "coco"
    class_names = ("__background__",) + VOC_CLASSES if style == "voc" else None
    return pred_eval(eval_step, model, batches, roidb, cfg.data, cfg.model.num_classes,
                     style=style, class_names=class_names, use_07_metric=use_07_metric,
                     dump_path=dump_path, progress=progress)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = apply_overrides(get_config(args.config), args.set)
    metrics = run_eval(cfg, ckpt_dir=args.ckpt, step=args.step, dump_path=args.dump,
                       use_07_metric=args.use_07_metric, limit=args.limit, device=args.device)
    for k, v in sorted(metrics.items()):
        print(f"{k} = {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
