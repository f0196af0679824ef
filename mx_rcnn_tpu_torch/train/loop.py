"""Build and run the single-device trainer (port of the core of
``mx_rcnn_tpu/train/loop.py``).

:func:`build_all` makes the model (random weights from ``train.seed``,
or the given ``state_dict``), freezes the reference's backbone prefixes,
and builds the schedule, the optimizer, the state and the step.
:func:`train` runs N steps over the synthetic dataset and logs one
metrics line per step; given a ``workdir`` it saves a checkpoint every
``train.checkpoint_every`` steps and after the last
(``<workdir>/<name>/ckpt``, ``train/checkpoint.py``).  Training on COCO or
VOC (which needs aspect grouping, flips and shuffling), resume, the mesh,
the guardian and evaluation in the loop are not ported.

Runs on the card: ``device=None`` means ``"cuda"``, and with no card it
raises rather than fall back to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import torch

from mx_rcnn_tpu_torch.config import Config, ScheduleConfig
from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
from mx_rcnn_tpu_torch.data.loader import batches
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.parallel.step import make_train_step
from mx_rcnn_tpu_torch.train.checkpoint import save_checkpoint
from mx_rcnn_tpu_torch.train.optim import SGDMomentum, frozen_mask, make_schedule
from mx_rcnn_tpu_torch.train.state import TrainState
from mx_rcnn_tpu_torch.utils.device import resolve_device
from mx_rcnn_tpu_torch.weights import init_variables

# The reference's fixed_param_prefix per backbone: stem and stage 1.
FREEZE_PREFIXES = {
    "resnet50": ("backbone/conv1", "backbone/bn1", "backbone/layer1"),
    "resnet101": ("backbone/conv1", "backbone/bn1", "backbone/layer1"),
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


def build_all(cfg: Config, device=None, variables: Optional[dict] = None):
    """-> (model, optimizer, state, step_fn, global_batch).  ``variables``:
    a ``state_dict`` to start from (default: ``init_variables`` seeded by
    ``train.seed``).  With ``backbone.freeze_stages > 0`` the backbone's
    ``FREEZE_PREFIXES`` are frozen."""
    dev = resolve_device(device)
    model = TwoStageDetector(cfg.model, device=dev)
    if variables is None:
        variables = init_variables(cfg.model, torch.Generator().manual_seed(cfg.train.seed))
    model.load_state_dict(variables)
    global_batch = cfg.train.per_device_batch
    sched = scale_schedule_steps(cfg.train.schedule, global_batch)
    lr_scale = global_batch / (sched.reference_batch or 16)
    freeze = ()
    if cfg.model.backbone.freeze_stages > 0:
        freeze = FREEZE_PREFIXES.get(cfg.model.backbone.name, ())
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


def train(cfg: Config, steps: Optional[int] = None, device=None,
          variables: Optional[dict] = None, log: Callable[[str], None] = print,
          workdir: Optional[str] = None) -> TrainState:
    """Run ``steps`` train steps (default: the schedule's total) on the
    synthetic dataset, uint8 images on the config's canvas; ``log`` gets
    one JSON line per step: its metrics and ``seconds``.  With a
    ``workdir``, checkpoints go to ``<workdir>/<name>/ckpt``.  Returns the
    final state."""
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(
            f"training on data.dataset={cfg.data.dataset!r} is not ported (it needs aspect "
            "grouping, flips and shuffling); set data.dataset=synthetic")
    model, _, state, step_fn, global_batch = build_all(cfg, device, variables)
    if steps is None:
        steps = scale_schedule_steps(cfg.train.schedule, global_batch).total_steps
    dataset = SyntheticDataset(image_hw=tuple(cfg.data.image_size),
                               num_classes=cfg.model.num_classes, seed=cfg.train.seed)
    dev = next(model.parameters()).device
    data = batches(dataset, global_batch, cfg.data, dev)
    for _ in range(steps):
        batch = next(data)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        # Reading the metrics waits for the step's last kernel: "seconds"
        # is the step's wall time, batch assembly excluded.
        values = {k: float(v) for k, v in metrics.items()}
        log(json.dumps({"step": state.step, **values,
                        "seconds": time.perf_counter() - t0}))
        if workdir and state.step % cfg.train.checkpoint_every == 0:
            save_checkpoint(checkpoint_dir(cfg, workdir), state)
    if workdir:
        save_checkpoint(checkpoint_dir(cfg, workdir), state)
    return state
