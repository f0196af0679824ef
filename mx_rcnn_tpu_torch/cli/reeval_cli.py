"""Re-score cached detections without a model (port of
``mx_rcnn_tpu/cli/reeval_cli.py``, the reference's ``rcnn/tools/reeval.py``).

    python -m mx_rcnn_tpu_torch.cli.reeval_cli runs/d.json --config r50_fpn_coco \\
        --set data.dataset=synthetic --dump-coco runs/results.json

Loads an ``eval_cli --dump`` file, scores it against the config's val
split with the dataset's evaluator and prints the metrics, one ``name =
value`` line each; ``--dump-coco`` and ``--dump-voc`` export the
detections as submission files.  Nothing here touches the card.
"""

from __future__ import annotations

import argparse
import sys

from mx_rcnn_tpu_torch.cli.common import (
    add_config_args,
    config_from_args,
    default_use_07_metric,
    setup_logging,
    submission_imageset,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(p)
    p.add_argument("detections", help="dump file from eval_cli --dump")
    p.add_argument("--use-07-metric", action=argparse.BooleanOptionalAction, default=None,
                   help="VOC 11-point AP (default: on for VOC2007 splits)")
    p.add_argument("--dump-coco", default=None, metavar="RESULTS.JSON",
                   help="export the detections as a COCO results json in the original "
                        "(sparse) category ids")
    p.add_argument("--dump-voc", default=None, metavar="DIR",
                   help="export the detections as VOC comp4 det files")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Score the dump and print the metrics; returns the metrics dict."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)

    from mx_rcnn_tpu_torch.data.datasets import VOC_CLASSES, build_dataset
    from mx_rcnn_tpu_torch.evalutil import evaluate_detections, load_detections
    from mx_rcnn_tpu_torch.evalutil.submission import write_submission_artifacts

    per_image = load_detections(args.detections)
    dataset = build_dataset(cfg.data, train=False)
    roidb = dataset.roidb()
    if args.dump_coco or args.dump_voc:
        write_submission_artifacts(
            per_image, coco_results_path=args.dump_coco,
            label_to_cat=getattr(dataset, "label_to_cat", None), voc_dets_dir=args.dump_voc,
            class_names=tuple(getattr(dataset, "classes", ())),
            voc_imageset=submission_imageset(cfg))
    use_07 = args.use_07_metric
    if use_07 is None:
        use_07 = default_use_07_metric(cfg)
    style = "voc" if cfg.data.dataset == "voc" else "coco"
    class_names = ("__background__",) + VOC_CLASSES if style == "voc" else None
    metrics = evaluate_detections(per_image, roidb, cfg.model.num_classes, style, class_names,
                                  use_07_metric=use_07)
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
