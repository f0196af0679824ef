"""Optimizer and LR schedule (port of ``mx_rcnn_tpu/train/optim.py``).

The JAX package's optax chain, written out over the trainable parameters:

  1. ``clip_by_global_norm(grad_clip)``: ``g`` if ``norm < grad_clip``,
     else ``(g / norm) * grad_clip``, the norm over trainable gradients
     only (``torch.nn.utils.clip_grad_norm_`` adds an epsilon and would
     change the bits);
  2. ``add_decayed_weights(weight_decay)`` on every trainable parameter
     but biases and norm scales (leaves named ``bias`` or ``scale``);
  3. SGD with momentum: ``t = g + momentum * t``, ``p = p - lr * t``.

Frozen parameters (``frozen_mask``) get no update, no decay and no
momentum; they carry ``requires_grad=False``, so their backward is never
computed either.  The schedule is evaluated in float32 operation for
operation as the JAX one, so its values are bitwise equal.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import ScheduleConfig, TrainConfig


def make_schedule(cfg: ScheduleConfig, scale: float = 1.0) -> Callable[[int], float]:
    """Warmup + MultiFactor decay: step -> lr (a float32 value).
    ``scale`` is the linear-scaling factor (global batch / reference)."""
    f32 = np.float32
    base = f32(cfg.base_lr * scale)
    warmup_factor = f32(cfg.warmup_factor)
    warmup_rise = f32(1.0 - cfg.warmup_factor)
    warmup_steps = f32(max(cfg.warmup_steps, 1))
    factor = f32(cfg.factor)

    def schedule(step: int) -> float:
        s = f32(step)
        warm = warmup_factor + warmup_rise * np.minimum(s / warmup_steps, f32(1.0))
        decay = f32(1.0)
        for boundary in cfg.decay_steps:
            decay = decay * (factor if s >= f32(boundary) else f32(1.0))
        return float(base * warm * decay)

    return schedule


def frozen_mask(names: Iterable[str], freeze_prefixes: tuple[str, ...]) -> dict[str, bool]:
    """True = trainable, for dotted parameter names.  Each freeze prefix
    is a ``/``-separated module path anchored at the root, its last
    component matched as a string prefix: ``"backbone/layer1"`` freezes
    every ``backbone.layer1_block*`` and leaves the heads' ``conv1``
    alone."""
    prefixes = [p.split("/") for p in freeze_prefixes]

    def trainable(name: str) -> bool:
        parts = name.split(".")
        for pre in prefixes:
            if len(parts) < len(pre):
                continue
            head, last = pre[:-1], pre[-1]
            if parts[: len(head)] == head and parts[len(head)].startswith(last):
                return False
        return True

    return {n: trainable(n) for n in names}


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of the sum of squares (float32)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class SGDMomentum:
    """The optax chain above over ``params`` {name: parameter}.  ``step``
    is the optimizer's own update count (the schedule's argument),
    starting at 0."""

    def __init__(self, params: dict[str, torch.nn.Parameter], cfg: TrainConfig,
                 schedule: Callable[[int], float]) -> None:
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.decays = [n.rsplit(".", 1)[-1] not in ("bias", "scale") for n in self.names]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.momentum = cfg.momentum
        self.weight_decay = cfg.weight_decay
        self.grad_clip = cfg.grad_clip
        self.schedule = schedule
        self.step = 0

    @torch.no_grad()
    def apply(self, grads: list[torch.Tensor], norm: torch.Tensor | None = None) -> float:
        """One update from ``grads`` (aligned with ``self.params``); returns
        the lr it used.  ``norm``: their global norm, if already known."""
        if norm is None:
            norm = global_norm(grads)
        keep = norm < self.grad_clip
        lr = self.schedule(self.step)
        for p, g, t, decay in zip(self.params, grads, self.trace, self.decays):
            g = torch.where(keep, g, (g / norm) * self.grad_clip)
            if decay:
                g = g + self.weight_decay * p
            t.copy_(g + self.momentum * t)
            p.sub_(lr * t)
        self.step += 1
        return lr
