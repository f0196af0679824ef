"""4-step alternate training (Ren et al. 2015) on the card (counterpart of
``mx_rcnn_tpu/cli/alternate_cli.py``).

    python -m mx_rcnn_tpu_torch.cli.alternate_cli --config vgg16_voc07 \\
        --set data.root=data/VOCdevkit --pretrained vgg16.pth --external-proposals

The reference runs four processes over four symbol graphs
(``rcnn/tools/train_rpn.py``, ``test_rpn.py``, ``train_rcnn.py``) and
merges the two resulting parameter files with ``combine_model``.  Here
every phase is one ``train/loop.py::train`` run of the same model; the
phases differ only in loss weights and frozen prefixes, and there is
nothing to combine, since one model holds the RPN and the box head:

  1. rpn1: train the RPN (R-CNN loss off; box head frozen);
  2. dump proposals over the train split (``proposals_rpn1.pkl``);
  3. rcnn1: train Fast R-CNN (RPN loss off; RPN head frozen);
  4. rpn2: retrain the RPN (R-CNN loss off; backbone and box head frozen);
  5. dump proposals again (``proposals_rpn2.pkl``);
  6. rcnn2: retrain Fast R-CNN (RPN loss off; backbone and RPN head
     frozen).

Two schedules:

- default (in-graph): the R-CNN phases keep the frozen RPN in the graph
  and sample its live proposals, which is training on its proposals; each
  phase continues from the previous one's weights (an in-graph frozen
  RPN only matches the trunk it was trained on), so ``--pretrained``
  seeds rpn1 only, and the dumps are artifacts.
- ``--external-proposals``: the reference's schedule.  Each R-CNN phase
  trains on the pkl the preceding RPN phase dumped (Fast R-CNN mode, the
  RPN out of the graph), and rcnn1 restarts from the initial weights and
  ``--pretrained``, as ``train_rcnn.py`` does.

A phase continues from the previous one's parameters with a fresh
optimizer (step 0, zero momentum, the schedule restarted).  Each phase's
run lies under ``<workdir>/<name>_<phase>``, the dumps under
``<workdir>/<name>/``, and the final parameters are checkpointed to
``<workdir>/<name>/ckpt`` under the base config's optimizer (the
reference's ``combine_model``), where ``eval_cli`` finds them; then one
evaluation pass over the val split prints the metrics, one ``name =
value`` line each.  SIGTERM or SIGINT drain the step in flight,
checkpoint the phase and exit with code 75.  ``--device`` defaults to the
card; without one it raises rather than fall back to the CPU (``--device
cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
from typing import Optional

from mx_rcnn_tpu_torch.cli.common import add_config_args, config_from_args, setup_logging
from mx_rcnn_tpu_torch.config import Config

log = logging.getLogger("mx_rcnn_tpu_torch")

# The shared convolutions: frozen in the second RPN and R-CNN phases.
SHARED_CONV = ("backbone", "fpn")
# (name, RPN loss on, R-CNN loss on, frozen prefixes, pkl dumped before it).
PHASES = (
    ("rpn1", True, False, ("box_head",), None),
    ("rcnn1", False, True, ("rpn",), "proposals_rpn1.pkl"),
    ("rpn2", True, False, SHARED_CONV + ("box_head",), None),
    ("rcnn2", False, True, SHARED_CONV + ("rpn",), "proposals_rpn2.pkl"),
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(p, default="vgg16_voc07")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--phase-steps", type=int, default=None,
                   help="steps a phase (default: the schedule's total_steps)")
    p.add_argument("--no-proposal-dump", action="store_true",
                   help="skip the proposal pkl dumps between phases")
    p.add_argument("--pretrained", default=None, metavar="PTH",
                   help="torchvision-layout ResNet or VGG-16 .pth; seeds rpn1, and with "
                        "--external-proposals rcnn1 too, as the reference does")
    p.add_argument("--strict-resume", action="store_true",
                   help="fail (instead of warn) when a phase's config drifts from the "
                        "workdir's recorded config.json")
    p.add_argument("--external-proposals", action="store_true",
                   help="the reference's schedule: R-CNN phases train on the pkl the "
                        "preceding RPN phase dumped, the RPN out of the graph")
    return p.parse_args(argv)


def _phase_cfg(cfg: Config, name: str, rpn_on: bool, rcnn_on: bool) -> Config:
    model = dataclasses.replace(
        cfg.model,
        rpn=dataclasses.replace(cfg.model.rpn, loss_weight=1.0 if rpn_on else 0.0),
        rcnn=dataclasses.replace(cfg.model.rcnn, loss_weight=1.0 if rcnn_on else 0.0),
    )
    return dataclasses.replace(cfg, name=f"{cfg.name}_{name}", model=model)


def alternate_train(cfg: Config, phase_steps: Optional[int] = None,
                    workdir: Optional[str] = None, dump_proposals_pkl: bool = True,
                    num_phases: int = 4, pretrained: Optional[str] = None,
                    external_proposals: bool = False, strict_resume: bool = False,
                    device=None):
    """Run the schedule and return the combined state: the last phase's
    parameters at its step, under the base config's optimizer (zero
    momentum), also saved to ``<workdir>/<name>/ckpt``.  ``num_phases`` < 4
    runs the first phases only; ``external_proposals``: the reference's
    schedule (module docstring)."""
    from mx_rcnn_tpu_torch.cli.eval_cli import dump_proposals
    from mx_rcnn_tpu_torch.train.checkpoint import save_checkpoint, state_payload
    from mx_rcnn_tpu_torch.train.loop import build_all, checkpoint_dir, train

    workdir = workdir or cfg.workdir
    if external_proposals and not dump_proposals_pkl:
        raise ValueError("--external-proposals requires the proposal dumps")
    state = None
    for name, rpn_on, rcnn_on, freeze, dump_before in PHASES[:num_phases]:
        proposals_path = None
        if dump_before and dump_proposals_pkl and state is not None:
            path = os.path.join(workdir, cfg.name, dump_before)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            dump_proposals(cfg, path, state=state, device=device)
            if external_proposals:
                proposals_path = path
        # rcnn1 of the reference's schedule restarts from the initial
        # weights: safe, since its proposals are precomputed.  rcnn2 keeps
        # rpn2's weights, whose trunk is shared and frozen by then.
        reseed = external_proposals and name == "rcnn1"
        if reseed and not pretrained:
            log.warning("--external-proposals without --pretrained: rcnn1 restarts from "
                        "RANDOM init (the reference re-seeds it from ImageNet)")
        fresh = state is None or reseed
        log.info("=== alternate phase %s (freeze: %s%s) ===", name, ",".join(freeze),
                 ", external proposals" if proposals_path else "")
        state = train(_phase_cfg(cfg, name, rpn_on, rcnn_on), steps=phase_steps, device=device,
                      variables=None if fresh else state.model.state_dict(), workdir=workdir,
                      pretrained=pretrained if fresh else None, strict_resume=strict_resume,
                      extra_freeze=freeze, proposals_path=proposals_path)
    # combine_model: the last phase's parameters (one model holds both
    # heads) in a state of the base config, whose optimizer (zero momentum,
    # no phase freeze) is what eval_cli and train_cli restore into.
    combined = build_all(cfg, device, variables=state.model.state_dict())[2]
    combined.step = state.step
    save_checkpoint(checkpoint_dir(cfg, workdir), state_payload(combined))
    return combined


def main(argv=None) -> dict:
    """Train the schedule, then evaluate; returns the metrics dict."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = config_from_args(args)
    state = alternate_train(cfg, phase_steps=args.phase_steps, workdir=cfg.workdir,
                            dump_proposals_pkl=not args.no_proposal_dump,
                            pretrained=args.pretrained,
                            external_proposals=args.external_proposals,
                            strict_resume=args.strict_resume, device=args.device)
    from mx_rcnn_tpu_torch.cli.eval_cli import run_eval

    metrics = run_eval(cfg, state=state, device=args.device)
    for k, v in sorted(metrics.items()):
        print(f"{k} = {v:.4f}")
    return metrics


def cli(argv=None) -> int:
    """The process entry point: 0 when done, ``RESUMABLE_EXIT_CODE`` (75)
    after a preemption's emergency checkpoint."""
    from mx_rcnn_tpu_torch.train.preemption import RESUMABLE_EXIT_CODE, Preempted

    try:
        main(argv)
    except Preempted as p:
        log.warning("preempted at step %d (checkpoint: %s); exiting %d", p.step, p.ckpt_dir,
                    RESUMABLE_EXIT_CODE)
        return RESUMABLE_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(cli())
