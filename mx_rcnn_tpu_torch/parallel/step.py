"""The single-device train and eval steps (port of the single-device
forms of ``mx_rcnn_tpu/parallel/step.py::make_train_step`` and
``make_eval_step``).

One call of the plain step runs forward, backward and the optimizer
update on the model's device.  The step's four random draws come from the
state's generator, seeded from ``(train.seed, step)``.  It returns the six
reference metrics and ``loss`` as they come out of ``forward_train``, plus
``nonfinite`` (1.0 when the gradients' global norm or any metric is not
finite) and ``lr``, all as device tensors: the step itself reads nothing
back to the host beyond what the plain NMS fixed point of the proposals
already does.

The two stacked forms take a sequence of batches of one canvas (the
loader's runs, ``data/loader.py``):

* ``train.accum_steps`` N > 1: one optimizer step over N microbatches
  (JAX's ``accum_step``).  Each microbatch runs forward and backward; the
  gradients are summed in the policy's ``accum_dtype``, divided by N and
  cast to the parameter dtype, then clipped and applied once; the metrics
  are the microbatches' means in float32.  The draws of the whole N x B
  batch are drawn once (``detection/graph.py::BatchDraws``) and microbatch
  j takes rows jB .. jB + B - 1, so an accumulated step samples the same
  anchors and rois image for image as one step over the N x B batch.  Each
  microbatch's losses are normalized by its own sampled count, so the two
  agree exactly when every image meets its sampling quota and to the
  normalizers' round-off otherwise (the JAX package's contract).
* ``train.steps_per_call`` K > 1: K plain steps, one a batch (JAX's
  ``multi_step``, a host loop here).  The call's metrics are the mean over
  the K steps in float32, ``lr`` the last step's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.detection.graph import (
    BatchDraws,
    Detections,
    forward_inference,
    forward_train,
)
from mx_rcnn_tpu_torch.train.optim import global_norm
from mx_rcnn_tpu_torch.train.state import TrainState, step_seed


def _mean_metrics(per: list[dict]) -> dict:
    """Each metric's mean over ``per`` in float32."""
    return {k: torch.stack([m[k].detach().to(torch.float32) for m in per]).mean(dim=0)
            for k in per[0]}


def _finish(state: TrainState, grads: list[torch.Tensor], metrics: dict) -> dict:
    """The guardian's finiteness flag, one optimizer update from ``grads``
    (aligned with the optimizer's parameters) and the step count; returns
    the metrics with ``nonfinite`` and ``lr``."""
    norm = global_norm(grads)
    finite = torch.isfinite(norm)
    for key in sorted(metrics):
        finite = finite & torch.all(torch.isfinite(metrics[key]))
    lr = state.optimizer.apply(grads, norm)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["nonfinite"] = 1.0 - finite.to(torch.float32)
    metrics["lr"] = torch.full((), lr, dtype=torch.float32, device=norm.device)
    state.step += 1
    return metrics


def _grads(params: list[torch.nn.Parameter]) -> list[torch.Tensor]:
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in params]


def make_train_step(pixel_stats=None, seed: int = 0, accum_steps: int = 1,
                    accum_dtype: torch.dtype = torch.float32, steps_per_call: int = 1):
    """``step(state, batch, draws=None) -> (state, metrics)``;
    ``pixel_stats`` is (mean, std) for uint8 batches, ``seed`` the
    config's ``train.seed``.  ``draws``: the step's :class:`Draws` over all
    its images, in place of the generator's (the parity tests hand in the
    JAX package's).  With ``accum_steps`` > 1 (gradients accumulated in
    ``accum_dtype``) or ``steps_per_call`` > 1, ``batch`` is a sequence of
    that many batches; 1 and 1 is the plain step."""
    if accum_steps > 1 and steps_per_call > 1:
        raise ValueError("accum_steps and steps_per_call both > 1: pick one")

    def step(state: TrainState, batch: Batch, draws=None):
        model, opt = state.model, state.optimizer
        state.generator.manual_seed(step_seed(seed, state.step))
        for p in model.parameters():
            p.grad = None
        _, metrics = forward_train(model, batch, state.generator if draws is None else draws,
                                   pixel_stats)
        metrics["loss"].backward()
        return state, _finish(state, _grads(opt.params), metrics)

    def accum_step(state: TrainState, batches: Sequence[Batch], draws=None):
        if len(batches) != accum_steps:
            raise ValueError(f"an accumulated step takes {accum_steps} microbatches, "
                             f"got {len(batches)}")
        model, opt = state.model, state.optimizer
        state.generator.manual_seed(step_seed(seed, state.step))
        b = batches[0].images.shape[0]
        whole = BatchDraws(state.generator if draws is None else draws, accum_steps * b)
        acc: Optional[list[torch.Tensor]] = None
        per = []
        for j, mb in enumerate(batches):
            for p in model.parameters():
                p.grad = None
            _, metrics = forward_train(model, mb, whole.micro(j, b), pixel_stats)
            metrics["loss"].backward()
            grads = [g.to(accum_dtype) for g in _grads(opt.params)]
            if acc is None:
                acc = grads
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            per.append({k: v.detach() for k, v in metrics.items()})
        for p in model.parameters():
            p.grad = None
        grads = [(a / accum_steps).to(p.dtype) for a, p in zip(acc, opt.params)]
        return state, _finish(state, grads, _mean_metrics(per))

    def multi_step(state: TrainState, batches: Sequence[Batch], draws=None):
        if len(batches) != steps_per_call or draws is not None:
            raise ValueError(f"a call takes {steps_per_call} batches and no draws")
        per = []
        for batch in batches:
            state, metrics = step(state, batch)
            per.append(metrics)
        metrics = _mean_metrics(per)
        metrics["lr"] = per[-1]["lr"]
        return state, metrics

    if accum_steps > 1:
        return accum_step
    if steps_per_call > 1:
        return multi_step
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
