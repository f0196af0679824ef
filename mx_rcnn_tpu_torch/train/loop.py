"""Build and run the single-device trainer (port of
``mx_rcnn_tpu/train/loop.py``, without the mesh, the execution plan,
stacked steps, the observability plane, the profile window and the
transfer guard).

:func:`build_all` makes the model (random weights from ``train.seed``,
the given ``state_dict``, and a torchvision ResNet or VGG-16 ``.pth``
over the backbone), freezes the reference's backbone prefixes, and builds the
schedule, the optimizer, the state and the step.  :func:`train` runs the
steps over any roidb that ``data/datasets.py::build_dataset`` returns, in
the JAX loader's batch schedule (``data/loader.py::DetectionLoader``),
on the RPN's proposals or, given a proposal pkl, on external ones (Fast
R-CNN mode).  A phase of the alternate schedule
(``cli/alternate_cli.py``) freezes more prefixes and starts from the
previous phase's weights with a fresh optimizer.
Metrics stay on the card between drains (every ``train.log_every`` steps,
at checkpoint boundaries and on preemption); a drain reads the interval
back in one transfer, shows it to the guardian, logs one JSON line and
appends to ``metrics.jsonl``.  Given a ``workdir``, the run directory
``<workdir>/<name>`` holds ``ckpt/`` (a step-0 checkpoint, one every
``train.checkpoint_every`` steps and one after the last),
``metrics.jsonl``, ``quarantine.jsonl`` and ``config.json``.  Fault
tolerance: ``resume`` restores the newest finite checkpoint and skips the
batches it consumed; SIGTERM/SIGINT drain, checkpoint and raise
``Preempted``; non-finite metrics roll back to the last finite
checkpoint and skip the offending data, ``train.guardian_rollbacks``
times, then raise ``TrainingDiverged``.

Runs on the card: ``device=None`` means ``"cuda"``, and with no card it
raises rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, Optional

import torch

from mx_rcnn_tpu_torch.config import Config, ScheduleConfig
from mx_rcnn_tpu_torch.data.datasets import build_dataset
from mx_rcnn_tpu_torch.data.loader import DetectionLoader, load_proposals
from mx_rcnn_tpu_torch.data.roidb import filter_roidb
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.parallel.prefetch import PrefetchStats, _timed_pulls
from mx_rcnn_tpu_torch.parallel.step import make_train_step
from mx_rcnn_tpu_torch.train.checkpoint import (
    delete_steps_after,
    finite_state,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from mx_rcnn_tpu_torch.train.guardian import Guardian
from mx_rcnn_tpu_torch.train.metrics import ScalarWriter, Speedometer, host_interval_metrics
from mx_rcnn_tpu_torch.train.optim import SGDMomentum, frozen_mask, make_schedule
from mx_rcnn_tpu_torch.train.preemption import Preempted, PreemptionGuard
from mx_rcnn_tpu_torch.train.state import TrainState
from mx_rcnn_tpu_torch.utils.device import resolve_device
from mx_rcnn_tpu_torch.weights import init_variables

logger = logging.getLogger("mx_rcnn_tpu_torch")

# The reference's fixed_param_prefix per backbone: stem and stage 1 for
# ResNet, groups 1-2 (conv1_x, conv2_x) for VGG.
FREEZE_PREFIXES = {
    "resnet50": ("backbone/conv1", "backbone/bn1", "backbone/layer1"),
    "resnet101": ("backbone/conv1", "backbone/bn1", "backbone/layer1"),
    "vgg16": ("backbone/group1", "backbone/group2"),
}


def scale_schedule_steps(sched: ScheduleConfig, global_batch: int) -> ScheduleConfig:
    """Rescale the step-denominated schedule fields by ``reference_batch /
    global_batch``; identity when ``reference_batch`` is 0 or matches."""
    ref = sched.reference_batch
    if not ref or global_batch == ref:
        return sched
    f = ref / global_batch
    return dataclasses.replace(
        sched,
        decay_steps=tuple(max(1, round(s * f)) for s in sched.decay_steps),
        total_steps=max(1, round(sched.total_steps * f)),
    )


def build_all(cfg: Config, device=None, variables: Optional[dict] = None,
              pretrained: Optional[str] = None, extra_freeze: tuple[str, ...] = ()):
    """-> (model, optimizer, state, step_fn, global_batch).  ``variables``:
    a ``state_dict`` to start from (default: ``init_variables`` seeded by
    ``train.seed``); ``pretrained``: a torchvision ResNet or VGG-16 ``.pth``
    whose tensors then replace the backbone's (and VGG's ``fc6``/``fc7``;
    ``train/import_torch.py``).  With
    ``backbone.freeze_stages > 0`` the backbone's ``FREEZE_PREFIXES`` are
    frozen, and ``extra_freeze`` (JAX module paths such as ``"rpn"`` or
    ``"box_head"``; ``optim.py::frozen_mask``) in any case.  The
    optimizer is fresh: step 0, zero momentum."""
    dev = resolve_device(device)
    model = TwoStageDetector(cfg.model, device=dev)
    if variables is None:
        variables = init_variables(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    if pretrained:
        from mx_rcnn_tpu_torch.train.import_torch import load_pretrained_backbone

        variables = load_pretrained_backbone(variables, pretrained)
    model.load_state_dict(variables)
    global_batch = cfg.train.per_device_batch
    sched = scale_schedule_steps(cfg.train.schedule, global_batch)
    lr_scale = global_batch / (sched.reference_batch or 16)
    freeze = ()
    if cfg.model.backbone.freeze_stages > 0:
        freeze = FREEZE_PREFIXES.get(cfg.model.backbone.name, ())
    freeze = tuple(freeze) + tuple(extra_freeze)
    params = dict(model.named_parameters())
    trainable = frozen_mask(params, freeze)
    for name, p in params.items():
        p.requires_grad_(trainable[name])
    optimizer = SGDMomentum({n: p for n, p in params.items() if trainable[n]}, cfg.train,
                            make_schedule(sched, lr_scale))
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       generator=torch.Generator(device=dev))
    step_fn = make_train_step(pixel_stats=(cfg.data.pixel_mean, cfg.data.pixel_std),
                              seed=cfg.train.seed)
    return model, optimizer, state, step_fn, global_batch


def checkpoint_dir(cfg: Config, workdir: Optional[str] = None) -> str:
    return f"{workdir or cfg.workdir}/{cfg.name}/ckpt"


def _flat_config(d: dict, prefix: str = "") -> dict:
    out = {}
    for key, v in d.items():
        if isinstance(v, dict):
            out.update(_flat_config(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = v
    return out


class ConfigDriftError(RuntimeError):
    """``strict_resume``: the resumed config differs from the run-start one."""


def _warn_config_drift(cfg: Config, config_json_path: str, strict: bool = False) -> None:
    """Log every field of ``cfg`` that differs from the run-start config
    recorded at ``config_json_path`` (a drift changes the schedule or the
    data order the resumed run replays); with ``strict``, raise
    :class:`ConfigDriftError` listing them all."""
    try:
        with open(config_json_path) as f:
            saved = _flat_config(json.load(f))
    except (OSError, ValueError):  # absent, unreadable or corrupt: nothing to compare
        return
    current = _flat_config(dataclasses.asdict(cfg))
    drift = []
    for key in sorted(set(saved) | set(current)):
        a, b = saved.get(key), current.get(key)
        b = list(b) if isinstance(b, tuple) else b
        if a != b:
            drift.append(f"{key}: {a!r} -> {b!r}")
            logger.warning("resume config drift: %s was %r at run start, now %r; schedule "
                           "and data continuity are NOT guaranteed across this change", key, a, b)
    if strict and drift:
        raise ConfigDriftError(f"strict resume: config drifted from the run-start config.json "
                               f"({config_json_path}):\n  " + "\n  ".join(drift))


def train(cfg: Config, steps: Optional[int] = None, device=None,
          variables: Optional[dict] = None, log: Callable[[str], None] = print,
          workdir: Optional[str] = None, resume: bool = False,
          pretrained: Optional[str] = None, strict_resume: bool = False,
          loader: Optional[DetectionLoader] = None, extra_freeze: tuple[str, ...] = (),
          proposals_path: Optional[str] = None) -> TrainState:
    """Train up to step ``steps`` (default: the schedule's total) and
    return the final state.

    ``log`` gets one JSON line a drain: the step, the interval's metric
    means (``nonfinite`` included), ``data_stall_ms`` (time in
    ``next(loader)`` a step) and ``img_s`` (images a second since the
    previous drain; null at the first).  ``workdir``: the run directory's
    parent (checkpoints, metrics, quarantine journal, config); without it
    nothing is written and the guardian can only detect and raise.
    ``resume``: continue from the newest finite checkpoint, on the same
    data schedule; ``strict_resume`` makes a config drift from the run's
    ``config.json`` an error.  ``pretrained``: a torchvision ResNet or
    VGG-16 ``.pth`` for the backbone.  ``loader``: a ``DetectionLoader``
    to draw from (default: the filtered train roidb of ``cfg.data``).
    ``extra_freeze``: prefixes frozen besides the backbone's
    (:func:`build_all`).  ``proposals_path``: a proposal pkl
    (``data/loader.py::load_proposals``) whose best
    ``rpn.train_post_nms_top_n`` boxes an image the default loader puts
    in ``Batch.ext_rois``; with ``rpn.loss_weight`` 0 that is Fast R-CNN
    mode, the RPN out of the graph.  ``variables`` from an earlier phase
    continue it: its parameters and FrozenBN buffers, a fresh optimizer,
    step 0 and the schedule restarted."""
    _, _, state, step_fn, global_batch = build_all(cfg, device, variables, pretrained,
                                                   extra_freeze)
    dev = next(state.model.parameters()).device
    if steps is None:
        steps = scale_schedule_steps(cfg.train.schedule, global_batch).total_steps
    run_dir = f"{workdir or cfg.workdir}/{cfg.name}"
    ckpt_dir = checkpoint_dir(cfg, workdir)
    if resume and latest_step(ckpt_dir) is not None:
        # Walks back past a truncated, corrupt or non-finite newest step.
        restore_checkpoint(ckpt_dir, state, validate=finite_state)
        logger.info("resumed from %s at step %d", ckpt_dir, state.step)
        _warn_config_drift(cfg, f"{run_dir}/config.json", strict=strict_resume)
    if loader is None:
        roidb = filter_roidb(build_dataset(cfg.data, train=True).roidb())
        loader = DetectionLoader(
            roidb, cfg.data, global_batch, dev, seed=cfg.train.seed,
            quarantine_path=f"{run_dir}/quarantine.jsonl" if workdir else None,
            proposals=load_proposals(proposals_path) if proposals_path else None,
            num_proposals=cfg.model.rpn.train_post_nms_top_n,
            with_masks=cfg.model.mask.enabled)

    start = state.step
    writer = None
    if workdir:
        # Rows past the restored step (a crash after a checkpoint, an
        # earlier run's rollback) are dropped, not duplicated.
        writer = ScalarWriter(f"{run_dir}/metrics.jsonl", resume=start > 0, resume_step=start)
        if start == 0:
            # The run-start config, against which every resume checks drift.
            with open(f"{run_dir}/config.json", "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=1)
        if latest_step(ckpt_dir) is None:
            # A rollback or resume inside the first checkpoint interval
            # returns here rather than aborting.
            save_checkpoint(ckpt_dir, state)

    stall = PrefetchStats()

    def data_iter(from_step: int, extra_skip: int):
        # After a rollback ``extra_skip`` batches of the schedule are
        # dropped: the retried steps see fresh data, never the poison.
        return _timed_pulls(loader.iter_from(from_step + extra_skip), stall)

    guardian = Guardian(max_rollbacks=cfg.train.guardian_rollbacks if workdir else 0,
                        spike_zscore=cfg.train.guardian_spike_z)
    speedo = Speedometer(global_batch)
    pending: list[dict] = []
    last_drain = start
    it = data_iter(start, 0)
    data_skip = 0      # batches the guardian skipped ahead of the schedule
    last_good = start  # newest boundary whose drained metrics were finite
    i = start
    try:
        with PreemptionGuard() as preempt:
            while i < steps:
                state, metrics = step_fn(state, next(it))
                pending.append(metrics)
                done = i + 1
                at_log = done % cfg.train.log_every == 0 or i == start
                at_ckpt = bool(workdir) and done % cfg.train.checkpoint_every == 0
                if at_log or at_ckpt or preempt.triggered:
                    # Checkpoint boundaries drain too: a step is saved only
                    # after its whole interval read back finite.
                    means, per_step = host_interval_metrics(pending)
                    pending.clear()
                    stall_s, _ = stall.take()
                    stall_ms = stall_s * 1000.0 / max(done - last_drain, 1)
                    last_drain = done
                    if guardian.observe(done, means, per_step) is not None:
                        restore_checkpoint(ckpt_dir, state, max_step=last_good,
                                           validate=finite_state)
                        restored = state.step
                        delete_steps_after(ckpt_dir, restored)
                        data_skip += done - restored
                        it = data_iter(restored, data_skip)
                        writer.truncate(restored)
                        speedo = Speedometer(global_batch)
                        last_drain = i = restored
                        continue
                    last_good = done
                    means["data_stall_ms"] = stall_ms
                    if at_log:
                        img_s = speedo(done, means)
                        log(json.dumps({"step": done, **means, "img_s": img_s}))
                        if writer:
                            writer.write(done, {k: v for k, v in means.items()
                                                if k != "nonfinite"})
                    if at_ckpt:
                        save_checkpoint(ckpt_dir, state)
                if preempt.triggered:
                    # Drained: persist synchronously and exit resumable.
                    if workdir:
                        save_checkpoint(ckpt_dir, state)
                    raise Preempted(done, ckpt_dir if workdir else None)
                i = done
    finally:
        if writer:
            writer.close()
    if workdir:
        save_checkpoint(ckpt_dir, state)
    return state
