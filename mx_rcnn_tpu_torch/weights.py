"""Weights for the port: the bridge from the JAX package's variables and a
torch-side initializer for runs without JAX.

The JAX detector keeps ``{"params": ..., "constants": ...}`` trees
(``"batch_stats"`` in place of ``"constants"`` under ``backbone.norm=bn``)
whose paths name the flax modules (``backbone/layer1_block0/conv1/kernel``,
``rpn/conv/bias``, ``constants/backbone/bn1/var``).  The port's modules
carry the same names, so a path maps to a ``state_dict`` key by joining it
with dots, with two renames and one transpose:

  * the RPN head is ``rpn`` in flax and ``rpn_head`` here;
  * a ``kernel`` becomes a ``weight``: conv HWIO -> OIHW (the inverse of
    ``mx_rcnn_tpu/train/import_torch.py``), dense (in, out) -> (out, in);
  * norm tensors keep their names: FrozenBN's ``scale/bias/mean/var``
    (all ``constants``, buffers here), ``bn``'s ``scale/bias`` (``params``)
    and ``mean/var`` (``batch_stats``, buffers here), ``gn``'s
    ``scale/bias`` (``params``).

A ``state_dict`` does not say which of its tensors are parameters, so
:func:`to_jax_variables` takes the model's ``backbone.norm`` to tell
FrozenBN's four from ``bn``'s (both modules have a ``var``).

The mask head's deconv is the one exception to the kernel rule: a flax
``ConvTranspose`` kernel (kh, kw, in, out) holds the taps flipped in both
spatial axes against ``torch.nn.functional.conv_transpose2d``'s weight
(in, out, kh, kw), so it converts as ``K[::-1, ::-1].transpose(2, 3, 0,
1)``.  At 256 -> 256 channels the plain HWIO -> OIHW transpose has the
same shape and would load without complaint.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import ModelConfig

_RENAME = {"rpn": "rpn_head"}
_UNRENAME = {v: k for k, v in _RENAME.items()}
# state_dict keys whose flax kernel is a ConvTranspose's.
_TRANSPOSED = ("mask_head.deconv.weight",)


def output_axis(key: str) -> int:
    """The output-channel axis of the ``state_dict`` weight ``key``: 1 for
    the transposed convolution's (in, out, kh, kw), 0 for every other
    (out, ...)."""
    return 1 if key in _TRANSPOSED else 0


def collection(key: str, state_dict, norm: str = "frozen_bn") -> str:
    """The flax collection of the ``state_dict`` tensor ``key`` in a model
    whose ``backbone.norm`` is ``norm``: a tensor of a module with a
    ``var`` is FrozenBN's (``"constants"``) or, under ``bn``, a running
    statistic (``"batch_stats"``: ``mean``, ``var``) or a parameter
    (``scale``, ``bias``); everything else is a parameter."""
    prefix, leaf = key.rsplit(".", 1)
    if f"{prefix}.var" not in state_dict:
        return "params"
    if norm == "bn":
        return "batch_stats" if leaf in ("mean", "var") else "params"
    return "constants"


def is_constant(key: str, state_dict, norm: str = "frozen_bn") -> bool:
    """Whether ``key`` is no parameter: a FrozenBN tensor or a ``bn``
    running statistic (:func:`collection`)."""
    return collection(key, state_dict, norm) != "params"


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:
        return kernel.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if kernel.ndim == 2:
        return kernel.T                       # (in, out) -> (out, in)
    raise ValueError(f"unexpected kernel rank {kernel.ndim}")


def _to_jax_layout(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 4:
        return weight.transpose(2, 3, 1, 0)   # OIHW -> HWIO
    if weight.ndim == 2:
        return weight.T
    raise ValueError(f"unexpected weight rank {weight.ndim}")


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """A flax ``{"params", "constants" or "batch_stats"}`` tree of numpy
    arrays -> a ``state_dict`` for :class:`TwoStageDetector` (CPU
    tensors)."""
    out = {}
    for coll in ("params", "constants", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            path = (_RENAME.get(path[0], path[0]),) + path[1:]
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                path = path[:-1] + ("weight",)
                if ".".join(path) in _TRANSPOSED:
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)   # flipped HWIO -> IOHW
                else:
                    arr = _to_torch_layout(arr)
            key = ".".join(path)
            if key in out:
                raise ValueError(f"two variables map to {key}")
            out[key] = torch.from_numpy(np.array(arr, order="C"))   # a copy, positive strides
    return out


def to_jax_variables(state_dict, norm: str = "frozen_bn") -> dict:
    """The inverse of :func:`from_jax_variables`: a ``state_dict`` of a
    model whose ``backbone.norm`` is ``norm`` -> a ``{"params",
    "constants"}`` tree of numpy arrays (``"batch_stats"`` under ``bn``;
    :func:`collection`).  A collection with nothing in it is left out, as
    flax has none: VGG-16 and ``gn`` have no ``constants``."""
    tree: dict = {"params": {}, "constants": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        path = key.split(".")
        coll = collection(key, state_dict, norm)
        arr = value.detach().cpu().numpy()
        if key in _TRANSPOSED:
            path, arr = path[:-1] + ["kernel"], arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif path[-1] == "weight":
            path, arr = path[:-1] + ["kernel"], _to_jax_layout(arr)
        path[0] = _UNRENAME.get(path[0], path[0])
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {coll: sub for coll, sub in tree.items() if sub}


# Flax's initializers (models/heads.py:24-25): normal(0.01) for the RPN
# conv/objectness, cls_score and every mask head kernel, normal(0.001) for
# the regressors.
_NORMAL_STD = {
    "rpn_head.conv.weight": 0.01,
    "rpn_head.objectness.weight": 0.01,
    "rpn_head.deltas.weight": 0.001,
    "box_head.cls_score.weight": 0.01,
    "box_head.bbox_pred.weight": 0.001,
}

# flax.linen.initializers.lecun_normal: truncated normal on [-2, 2] std
# units, std scaled up by 1/0.8796... so the variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def init_variables(cfg: ModelConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh ``state_dict`` with the flax initializers' distributions:
    lecun-normal conv and dense kernels, normal(0.01)/normal(0.001) head
    kernels, zero biases, identity norms (``scale`` and ``var`` 1, ``bias``
    and ``mean`` 0, whatever ``backbone.norm``).  CPU tensors."""
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
    from mx_rcnn_tpu_torch.models.norm import BatchNorm, FrozenBatchNorm, GroupNorm

    model = TwoStageDetector(cfg, device="meta")
    shapes = model.state_dict()
    norms = {name for name, m in model.named_modules()
             if isinstance(m, (FrozenBatchNorm, BatchNorm, GroupNorm))}
    out = {}
    with torch.no_grad():
        for key, t in shapes.items():
            value = torch.empty(t.shape, dtype=torch.float32)
            prefix, leaf = key.rsplit(".", 1)
            if prefix in norms:
                value.fill_(1.0 if leaf in ("scale", "var") else 0.0)
            elif leaf == "bias":
                value.zero_()
            elif key in _NORMAL_STD or key.startswith("mask_head."):
                torch.nn.init.normal_(value, 0.0, _NORMAL_STD.get(key, 0.01),
                                      generator=generator)
            else:
                fan_in = math.prod(t.shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                torch.nn.init.trunc_normal_(value, 0.0, std, -2.0 * std, 2.0 * std,
                                            generator=generator)
            out[key] = value
    return out
