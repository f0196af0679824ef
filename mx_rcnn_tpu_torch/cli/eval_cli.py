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

``--proposals OUT.PKL`` runs the RPN alone over a split instead
(``--proposals-split``, default val; train takes the train pre/post-NMS
counts) and writes each image's valid proposals in original image
coordinates (the reference's ``test_rpn.py``); ``--from-proposals
IN.PKL`` scores such a pkl's boxes instead of the RPN's (Fast R-CNN
testing, the reference's ``test_rcnn --has_rpn false``):

    python -m mx_rcnn_tpu_torch.cli.eval_cli --config vgg16_voc07 \
        --ckpt runs/vgg16_voc07/ckpt --proposals runs/val.pkl
    python -m mx_rcnn_tpu_torch.cli.eval_cli --config vgg16_voc07 \
        --ckpt runs/vgg16_voc07/ckpt --from-proposals runs/val.pkl

Not ported: sharded and resumable evaluation, ``--dump-coco`` and
``--dump-voc``, ``--vis``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pickle
import sys
from typing import Callable, Optional

from mx_rcnn_tpu_torch.config import Config, apply_overrides, available_configs, get_config

log = logging.getLogger("mx_rcnn_tpu_torch")


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
    p.add_argument("--proposals", default=None, metavar="OUT.PKL",
                   help="dump RPN proposals per image instead of evaluating (test_rpn)")
    p.add_argument("--from-proposals", default=None, metavar="IN.PKL",
                   help="score this proposal pkl instead of running the RPN (Fast R-CNN "
                        "testing, test_rcnn --has_rpn false)")
    p.add_argument("--proposals-split", choices=("train", "val"), default=None,
                   help="the split --proposals dumps (default val; train: the Fast R-CNN "
                        "training input, at the train pre/post-NMS counts)")
    return p.parse_args(argv)


def default_use_07_metric(cfg: Config) -> bool:
    """The 11-point AP for VOC2007 splits (the reference's choice), the
    area metric everywhere else."""
    return cfg.data.dataset == "voc" and cfg.data.val_split.startswith("2007")


def _eval_loader(cfg: Config, batch_size: int, device, limit: Optional[int] = None,
                 proposals_path: Optional[str] = None, split: Optional[str] = None):
    """-> (roidb, batches): the val split (or ``split``), cut to its first
    ``limit`` images (the metric's roidb too, so absent images do not
    score as misses), and its eval batches on ``device``, carrying the
    best ``rpn.test_post_nms_top_n`` boxes an image of ``proposals_path``
    when given."""
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import eval_batches, load_proposals

    roidb = build_dataset(cfg.data, split=split, train=False).roidb()
    if limit is not None:
        roidb = roidb[:limit]
    if not roidb:
        raise ValueError("empty eval roidb")
    proposals = load_proposals(proposals_path) if proposals_path else None
    return roidb, eval_batches(roidb, cfg.data, batch_size, device, proposals=proposals,
                               num_proposals=cfg.model.rpn.test_post_nms_top_n)


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
             progress: Optional[Callable[[int], None]] = None,
             proposals_path: Optional[str] = None) -> dict:
    """Evaluate ``state`` (a train state), or the checkpoint restored from
    ``ckpt_dir``, on the config's val split; returns the metrics dict.
    ``progress`` gets the count of images done after each one.
    ``proposals_path``: score that pkl's proposals instead of the RPN's."""
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
    roidb, batches = _eval_loader(cfg, max(cfg.model.test.per_device_batch, 1), dev, limit,
                                  proposals_path)
    style = "voc" if cfg.data.dataset == "voc" else "coco"
    class_names = ("__background__",) + VOC_CLASSES if style == "voc" else None
    return pred_eval(eval_step, model, batches, roidb, cfg.data, cfg.model.num_classes,
                     style=style, class_names=class_names, use_07_metric=use_07_metric,
                     dump_path=dump_path, progress=progress)


def dump_proposals(cfg: Config, out_path: str, state=None, ckpt_dir: Optional[str] = None,
                   step: Optional[int] = None, train_split: bool = True,
                   use_train_counts: Optional[bool] = None, device=None) -> dict:
    """Run the RPN alone (``forward_proposals``) over the train split (or
    the val split) of ``state`` or a restored checkpoint and pickle
    image_id -> {"boxes": (n, 4) in original image coordinates,
    "scores": (n,)}, the valid proposals only, one entry an image (a
    padded batch's repeats are not read) to ``out_path``; returns the map.
    The alternate schedule's bridge from an RPN phase to a Fast R-CNN one.

    ``use_train_counts`` (default: ``train_split``) generates the train
    pre/post-NMS top-n: a pool for Fast R-CNN training must be the one
    training samples from."""
    import torch

    from mx_rcnn_tpu_torch.data.loader import record_scale
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.detection.graph import forward_proposals
    from mx_rcnn_tpu_torch.parallel.step import eval_variables
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if state is None:
        state = _restored_state(cfg, ckpt_dir, step, dev)
    if use_train_counts is None:
        use_train_counts = train_split
    if use_train_counts:
        rpn = cfg.model.rpn
        rpn = dataclasses.replace(rpn, test_pre_nms_top_n=rpn.train_pre_nms_top_n,
                                  test_post_nms_top_n=rpn.train_post_nms_top_n)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, rpn=rpn))
    model = TwoStageDetector(cfg.model, device=dev)
    model.load_state_dict(eval_variables(state))
    model.eval()
    stats = (cfg.data.pixel_mean, cfg.data.pixel_std)
    split = cfg.data.train_split if train_split else cfg.data.val_split
    _, batches = _eval_loader(cfg, max(cfg.model.test.per_device_batch, 1), dev, split=split)
    out: dict[str, dict] = {}
    for batch, recs in batches:
        with torch.inference_mode():
            props = forward_proposals(model, batch, stats)
        rois, scores, valid = (x[:len(recs)].cpu().numpy() for x in props)
        for i, rec in enumerate(recs):
            out[rec.image_id] = {"boxes": rois[i][valid[i]] / record_scale(cfg.data, rec),
                                 "scores": scores[i][valid[i]]}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    log.info("wrote %d images' proposals to %s", len(out), out_path)
    return out


def main(argv=None) -> dict:
    """Evaluate (``--from-proposals``: on a pkl's boxes) and print the
    metrics, or with ``--proposals`` dump proposals; returns the metrics
    dict or the proposal map."""
    args = parse_args(argv)
    cfg = apply_overrides(get_config(args.config), args.set)
    if args.proposals and args.from_proposals:
        raise SystemExit("--proposals (dump) and --from-proposals (score) are exclusive")
    if args.proposals_split and not args.proposals:
        raise SystemExit("--proposals-split only applies with --proposals")
    if args.proposals:
        props = dump_proposals(cfg, args.proposals, ckpt_dir=args.ckpt, step=args.step,
                               train_split=args.proposals_split == "train",
                               device=args.device)
        print(f"wrote {len(props)} images' proposals to {args.proposals}")
        return props
    metrics = run_eval(cfg, ckpt_dir=args.ckpt, step=args.step, dump_path=args.dump,
                       use_07_metric=args.use_07_metric, limit=args.limit, device=args.device,
                       proposals_path=args.from_proposals)
    for k, v in sorted(metrics.items()):
        print(f"{k} = {v:.4f}")
    return metrics


def cli(argv=None) -> int:
    """The process entry point: 0 when done (``main`` returns a dict,
    which ``sys.exit`` would take for a failure)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
