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

Sharded and preemptible (``--resumable``, ``--shard-dir``): the eval
schedule is cut into shards of ``--shard-size`` batches, each written to
its own file as it finishes; SIGTERM or SIGINT let the shard in flight
land, then the run exits with code 75, and ``--resume`` recomputes only
the missing shards.  The dump (``--dump``) is merged from the shard files
and is byte for byte an uninterrupted run's:

    python -m mx_rcnn_tpu_torch.cli.eval_cli --config r50_fpn_coco \
        --ckpt runs/r50_fpn_coco/ckpt --shard-dir runs/shards --dump runs/d.json
    # exit 75 after a SIGTERM; then the same command with --resume

``--dump-coco RESULTS.JSON`` and ``--dump-voc DIR`` also write the
submission files (a COCO results json in the original category ids; VOC
comp4 det files), and ``--vis N`` draws the first N images into
``<workdir>/<config>/vis`` (matplotlib; refused up front where it is not
installed).  A record whose image cannot be read, or whose annotations
are malformed or carry a class id at or above ``model.num_classes``, is
quarantined to ``<workdir>/<config>/quarantine.jsonl`` and scored as a
blank image: its gt counts as misses.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import pickle
import sys
from typing import Callable, Optional

from mx_rcnn_tpu_torch.cli.common import (
    add_config_args,
    config_from_args,
    default_use_07_metric,
    setup_logging,
    submission_imageset,
)
from mx_rcnn_tpu_torch.config import Config

log = logging.getLogger("mx_rcnn_tpu_torch")

# train/preemption.py's RESUMABLE_EXIT_CODE, for the help text.
_RESUMABLE_CODE = 75


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(p)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (default: <workdir>/<config name>/ckpt)")
    p.add_argument("--step", type=int, default=None, help="checkpoint step")
    p.add_argument("--dump", default=None, help="write the detections here (reeval input)")
    p.add_argument("--dump-coco", default=None, metavar="RESULTS.JSON",
                   help="also write a COCO results json in the original (sparse) category "
                        "ids, the format the COCO server and pycocotools' loadRes score")
    p.add_argument("--dump-voc", default=None, metavar="DIR",
                   help="also write VOC comp4 per-class det files into DIR")
    p.add_argument("--limit", type=int, default=None, metavar="N",
                   help="evaluate only the first N images")
    p.add_argument("--use-07-metric", action=argparse.BooleanOptionalAction, default=None,
                   help="VOC 11-point AP (default: on for VOC2007 splits)")
    p.add_argument("--vis", type=int, default=0, metavar="N",
                   help="draw the first N evaluated images with their detections into "
                        "<workdir>/<config>/vis (needs matplotlib)")
    p.add_argument("--resumable", action="store_true",
                   help="preemption-safe evaluation: shard files under --shard-dir; SIGTERM "
                        "lets the shard in flight land and exits "
                        f"{_RESUMABLE_CODE}, to be re-run with --resume")
    p.add_argument("--shard-dir", default=None, metavar="DIR",
                   help="where the shard files and manifest live (implies --resumable; "
                        "default <workdir>/<config>/eval_shards)")
    p.add_argument("--shard-size", type=int, default=8, metavar="N",
                   help="eval batches a shard (default 8)")
    p.add_argument("--shard-retries", type=int, default=1, metavar="N",
                   help="retries of a failed shard before giving up (default 1)")
    p.add_argument("--resume", action="store_true",
                   help="skip the shards on disk (the schedule's fingerprint is checked)")
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


def _eval_loader(cfg: Config, batch_size: int, device, limit: Optional[int] = None,
                 proposals_path: Optional[str] = None, split: Optional[str] = None):
    """-> (dataset, roidb, loader): the val split (or ``split``), cut to
    its first ``limit`` images (the metric's roidb too, so absent images
    do not score as misses), and its eval loader on ``device``
    (``DetectionLoader(train=False)``), carrying the best
    ``rpn.test_post_nms_top_n`` boxes an image of ``proposals_path`` when
    given.  Records are checked against ``model.num_classes``, and the bad
    ones quarantined to ``<workdir>/<name>/quarantine.jsonl``, as the JAX
    eval loader does."""
    from mx_rcnn_tpu_torch.data.datasets import build_dataset
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader, load_proposals

    dataset = build_dataset(cfg.data, split=split, train=False)
    roidb = dataset.roidb()
    if limit is not None:
        roidb = roidb[:limit]
    if not roidb:
        raise ValueError("empty eval roidb")
    proposals = load_proposals(proposals_path) if proposals_path else None
    loader = DetectionLoader(
        roidb, cfg.data, batch_size, device, train=False, proposals=proposals,
        num_proposals=cfg.model.rpn.test_post_nms_top_n, num_classes=cfg.model.num_classes,
        quarantine_path=f"{cfg.workdir}/{cfg.name}/quarantine.jsonl" if cfg.workdir else None)
    return dataset, roidb, loader


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
             proposals_path: Optional[str] = None, vis_count: int = 0,
             coco_results_path: Optional[str] = None, voc_dets_dir: Optional[str] = None,
             shard_dir: Optional[str] = None, shard_size: int = 8, resume: bool = False,
             shard_retries: int = 1) -> dict:
    """Evaluate ``state`` (a train state), or the checkpoint restored from
    ``ckpt_dir``, on the config's val split; returns the metrics dict.
    ``progress`` gets the count of images done (after each image, or with
    ``shard_dir`` after each shard).  ``proposals_path``: score that pkl's
    proposals instead of the RPN's.  ``coco_results_path`` /
    ``voc_dets_dir``: also write the submission files.  ``vis_count``:
    draw that many images into ``<workdir>/<name>/vis``.

    ``shard_dir``: preemption-safe sharded evaluation
    (``evalutil/pred_eval.py::collect_detections_sharded``): shard files
    of ``shard_size`` batches, ``resume`` skipping the shards on disk,
    SIGTERM or SIGINT letting the shard in flight land and raising
    ``Preempted`` (``cli`` maps it to exit 75)."""
    from mx_rcnn_tpu_torch.data.datasets import VOC_CLASSES
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.evalutil.pred_eval import pred_eval
    from mx_rcnn_tpu_torch.parallel.step import eval_variables, make_eval_step
    from mx_rcnn_tpu_torch.train.preemption import PreemptionGuard
    from mx_rcnn_tpu_torch.utils.device import resolve_device

    if vis_count > 0:
        # Refused before any work: the drawing comes after the whole pass.
        from mx_rcnn_tpu_torch.evalutil.vis import require_matplotlib

        require_matplotlib()
    dev = resolve_device(device)
    if use_07_metric is None:
        use_07_metric = default_use_07_metric(cfg)
    if state is None:
        state = _restored_state(cfg, ckpt_dir, step, dev)
    model = TwoStageDetector(cfg.model, device=dev)
    model.load_state_dict(eval_variables(state))
    model.eval()
    eval_step = make_eval_step(pixel_stats=(cfg.data.pixel_mean, cfg.data.pixel_std))
    dataset, roidb, loader = _eval_loader(cfg, max(cfg.model.test.per_device_batch, 1), dev,
                                          limit, proposals_path)
    style = "voc" if cfg.data.dataset == "voc" else "coco"
    class_names = None
    if style == "voc":
        class_names = ("__background__",) + VOC_CLASSES
    elif voc_dets_dir:
        # comp4 files are named by class; other datasets name their own.
        class_names = tuple(getattr(dataset, "classes", ()))
    if voc_dets_dir and len(class_names or ()) <= 1:
        # write_submission_artifacts says the same, but only after the
        # whole pass: refuse before the first batch.
        raise ValueError("--dump-voc needs foreground class names; the dataset exposes "
                         f"{tuple(class_names or ())!r} — comp4 det files are per-class-NAME")
    # A COCO submission carries the original sparse category ids; only the
    # COCO dataset has the map (other ids are already dense: the identity).
    label_to_cat = getattr(dataset, "label_to_cat", None) if coco_results_path else None
    # The guard turns SIGTERM/SIGINT into a drain at a shard boundary;
    # without shards there is no boundary to drain to.
    with (PreemptionGuard() if shard_dir else contextlib.nullcontext()) as guard:
        return pred_eval(
            eval_step, model, loader, roidb, cfg.data, cfg.model.num_classes, style=style,
            class_names=class_names, use_07_metric=use_07_metric, dump_path=dump_path,
            progress=progress,
            vis_dir=f"{cfg.workdir}/{cfg.name}/vis" if vis_count > 0 else None,
            vis_count=vis_count, coco_results_path=coco_results_path,
            label_to_cat=label_to_cat, voc_dets_dir=voc_dets_dir,
            voc_imageset=submission_imageset(cfg), shard_dir=shard_dir, shard_size=shard_size,
            resume=resume, shard_retries=shard_retries, guard=guard)


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
    _, _, batches = _eval_loader(cfg, max(cfg.model.test.per_device_batch, 1), dev,
                                 split=split)
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
    metrics, one ``name = value`` line each, or with ``--proposals`` dump
    proposals; returns the metrics dict or the proposal map."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)
    if args.proposals and args.from_proposals:
        raise SystemExit("--proposals (dump) and --from-proposals (score) are exclusive")
    if args.proposals_split and not args.proposals:
        raise SystemExit("--proposals-split only applies with --proposals")
    if args.proposals:
        if args.resumable or args.shard_dir or args.resume:
            raise SystemExit("--proposals does not support sharded/resumable mode")
        props = dump_proposals(cfg, args.proposals, ckpt_dir=args.ckpt, step=args.step,
                               train_split=args.proposals_split == "train",
                               device=args.device)
        print(f"wrote {len(props)} images' proposals to {args.proposals}")
        return props
    if args.resume and not (args.resumable or args.shard_dir):
        raise SystemExit("--resume requires --resumable (or --shard-dir)")
    shard_dir = args.shard_dir
    if args.resumable and not shard_dir:
        shard_dir = f"{cfg.workdir}/{cfg.name}/eval_shards"
    metrics = run_eval(cfg, ckpt_dir=args.ckpt, step=args.step, dump_path=args.dump,
                       use_07_metric=args.use_07_metric, limit=args.limit, device=args.device,
                       proposals_path=args.from_proposals, vis_count=args.vis,
                       coco_results_path=args.dump_coco, voc_dets_dir=args.dump_voc,
                       shard_dir=shard_dir, shard_size=args.shard_size, resume=args.resume,
                       shard_retries=args.shard_retries)
    for k, v in sorted(metrics.items()):
        print(f"{k} = {v:.4f}")
    return metrics


def cli(argv=None) -> int:
    """The process entry point: 0 when done (``main`` returns a dict,
    which ``sys.exit`` would take for a failure); ``RESUMABLE_EXIT_CODE``
    (75) when a sharded run was preempted after its shard in flight
    landed, so that a supervisor re-runs it with ``--resume``."""
    from mx_rcnn_tpu_torch.train.preemption import RESUMABLE_EXIT_CODE, Preempted

    try:
        main(argv)
    except Preempted as p:
        log.warning("eval preempted after shard %d (shards in %s); exiting %d, requeue with "
                    "--resume", p.step, p.ckpt_dir, RESUMABLE_EXIT_CODE)
        return RESUMABLE_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(cli())
