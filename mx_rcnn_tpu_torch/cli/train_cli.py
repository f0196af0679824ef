"""Train the port on the card (counterpart of ``mx_rcnn_tpu/cli/train_cli.py``).

    python -m mx_rcnn_tpu_torch.cli.train_cli --config r50_fpn_coco \\
        --set data.root=data/coco --pretrained resnet50.pth --workdir runs

Trains on the config's train split (``data.dataset`` coco, voc or
synthetic) in the JAX loader's batch schedule, prints one JSON metrics
line every ``train.log_every`` steps, and keeps the run under
``<workdir>/<config name>``: checkpoints in ``ckpt/``, ``metrics.jsonl``,
``quarantine.jsonl`` and ``config.json`` (``--workdir`` defaults to the
config's ``workdir``).  Then, unless ``--no-eval``, one evaluation pass
over the val split prints the metrics, one ``name = value`` line each.
``--resume`` continues from the newest checkpoint on the same data
schedule (``--strict-resume``: a config drift from the run's
``config.json`` is an error).  SIGTERM or SIGINT drain the step in
flight, checkpoint and exit with code 75 (requeue with ``--resume``).
``--proposals PKL`` trains on that proposal pkl's boxes (``eval_cli
--proposals --proposals-split train``) instead of the RPN's; with ``--set
model.rpn.loss_weight=0`` the RPN leaves the graph (Fast R-CNN mode, the
reference's ``train_rcnn.py``).  ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of steps 10-15 into DIR.  ``--set
obs.enabled=true`` turns on the observability plane (journal, spans and
flight dumps under ``<workdir>/<config name>/obs``; ``--set
obs.metrics_port=0`` adds a ``/metrics`` endpoint on an ephemeral port of
127.0.0.1).  ``--device`` defaults to the card;
without one it raises rather than fall back to the CPU (``--device cpu``
asks for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

from mx_rcnn_tpu_torch.cli.common import add_config_args, config_from_args, setup_logging

log = logging.getLogger("mx_rcnn_tpu_torch")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(p)
    p.add_argument("--steps", type=int, default=None,
                   help="train steps (default: the schedule's total_steps)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--seed", type=int, default=None, help="override train.seed")
    p.add_argument("--resume", action="store_true", help="resume from the workdir's checkpoints")
    p.add_argument("--strict-resume", action="store_true",
                   help="fail (instead of warn) when the resumed config drifts from the "
                        "workdir's recorded config.json")
    p.add_argument("--no-eval", action="store_true", help="skip the final evaluation pass")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of steps 10-15 to DIR")
    p.add_argument("--pretrained", default=None, metavar="PTH",
                   help="torchvision-layout ResNet or VGG-16 .pth to seed the backbone")
    p.add_argument("--proposals", default=None, metavar="PKL",
                   help="train the box head on this external proposal pkl (eval_cli "
                        "--proposals) instead of the RPN's; pair with --set "
                        "model.rpn.loss_weight=0 to drop the RPN from the graph")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train, then evaluate unless ``--no-eval``; returns ``{"final_step",
    **eval metrics}``."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=args.seed))
    from mx_rcnn_tpu_torch.train.loop import train

    state = train(cfg, steps=args.steps, device=args.device, workdir=cfg.workdir,
                  resume=args.resume, pretrained=args.pretrained,
                  strict_resume=args.strict_resume, proposals_path=args.proposals,
                  profile_dir=args.profile)
    metrics: dict = {"final_step": state.step}
    if not args.no_eval:
        from mx_rcnn_tpu_torch.cli.eval_cli import run_eval

        evaluated = run_eval(cfg, state=state, device=args.device)
        for k, v in sorted(evaluated.items()):
            print(f"{k} = {v:.4f}")
        metrics.update(evaluated)
    return metrics


def cli(argv=None) -> int:
    """The process entry point: 0 when done, ``RESUMABLE_EXIT_CODE`` (75)
    after a preemption's emergency checkpoint."""
    from mx_rcnn_tpu_torch.train.preemption import RESUMABLE_EXIT_CODE, Preempted

    try:
        main(argv)
    except Preempted as p:
        log.warning("preempted at step %d (checkpoint: %s); exiting %d, requeue with --resume",
                    p.step, p.ckpt_dir, RESUMABLE_EXIT_CODE)
        return RESUMABLE_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(cli())
