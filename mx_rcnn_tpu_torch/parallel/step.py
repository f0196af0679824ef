"""The single-device train and eval steps (port of the single-device
forms of ``mx_rcnn_tpu/parallel/step.py::make_train_step`` and
``make_eval_step``).

One call runs forward, backward and the optimizer update on the model's
device.  The step's four random draws come from the state's generator,
seeded from ``(train.seed, step)``.  It returns the six reference metrics
and ``loss`` as they come out of ``forward_train``, plus ``nonfinite``
(1.0 when the gradients' global norm or any metric is not finite) and
``lr``, all as device tensors: the step itself reads nothing back to the
host beyond what the plain NMS fixed point of the proposals already does.
"""

from __future__ import annotations

import torch

from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.detection.graph import Detections, forward_inference, forward_train
from mx_rcnn_tpu_torch.train.optim import global_norm
from mx_rcnn_tpu_torch.train.state import TrainState, step_seed


def make_train_step(pixel_stats=None, seed: int = 0):
    """``step(state, batch) -> (state, metrics)``; ``pixel_stats`` is
    (mean, std) for uint8 batches, ``seed`` the config's ``train.seed``."""

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        state.generator.manual_seed(step_seed(seed, state.step))
        for p in model.parameters():
            p.grad = None
        _, metrics = forward_train(model, batch, state.generator, pixel_stats)
        metrics["loss"].backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
        norm = global_norm(grads)
        finite = torch.isfinite(norm)
        for key in sorted(metrics):
            finite = finite & torch.all(torch.isfinite(metrics[key]))
        lr = opt.apply(grads, norm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["nonfinite"] = 1.0 - finite.to(torch.float32)
        metrics["lr"] = torch.full((), lr, dtype=torch.float32, device=norm.device)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(pixel_stats=None):
    """``eval_step(model, batch) -> Detections``: ``forward_inference``
    under ``torch.inference_mode()``; ``pixel_stats`` is (mean, std) for
    uint8 batches."""

    def step(model, batch: Batch) -> Detections:
        with torch.inference_mode():
            return forward_inference(model, batch, pixel_stats)

    return step


def eval_variables(state: TrainState) -> dict[str, torch.Tensor]:
    """Inference weights of a train state: the model's ``state_dict`` (no
    weight folding: the decode applies ``rcnn.bbox_weights`` in-graph)."""
    return state.model.state_dict()
