"""Weights for the port: the bridge from the JAX package's variables and a
torch-side initializer for runs without JAX.

The JAX detector keeps ``{"params": ..., "constants": ...}`` trees whose
paths name the flax modules (``backbone/layer1_block0/conv1/kernel``,
``rpn/conv/bias``, ``constants/backbone/bn1/var``).  The port's modules
carry the same names, so a path maps to a ``state_dict`` key by joining it
with dots, with two renames and one transpose:

  * the RPN head is ``rpn`` in flax and ``rpn_head`` here;
  * a ``kernel`` becomes a ``weight``: conv HWIO -> OIHW (the inverse of
    ``mx_rcnn_tpu/train/import_torch.py``), dense (in, out) -> (out, in);
  * FrozenBN ``scale/bias/mean/var`` are buffers under the same names.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import ModelConfig

_RENAME = {"rpn": "rpn_head"}
_UNRENAME = {v: k for k, v in _RENAME.items()}


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
    """A flax ``{"params", "constants"}`` tree of numpy arrays -> a
    ``state_dict`` for :class:`TwoStageDetector` (CPU tensors)."""
    out = {}
    for coll in ("params", "constants"):
        for path, leaf in _flatten(variables.get(coll, {})):
            path = (_RENAME.get(path[0], path[0]),) + path[1:]
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                path, arr = path[:-1] + ("weight",), _to_torch_layout(arr)
            key = ".".join(path)
            if key in out:
                raise ValueError(f"two variables map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def to_jax_variables(state_dict) -> dict:
    """The inverse of :func:`from_jax_variables`: a ``state_dict`` -> a
    ``{"params", "constants"}`` tree of numpy arrays.  A module with a
    ``var`` buffer is a FrozenBN, whose tensors are constants; a model
    without one (VGG-16) has no ``constants``, as in flax."""
    tree: dict = {"params": {}, "constants": {}}
    for key, value in state_dict.items():
        path = key.split(".")
        prefix = ".".join(path[:-1])
        coll = "constants" if f"{prefix}.var" in state_dict else "params"
        arr = value.detach().cpu().numpy()
        if path[-1] == "weight":
            path, arr = path[:-1] + ["kernel"], _to_jax_layout(arr)
        path[0] = _UNRENAME.get(path[0], path[0])
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {coll: sub for coll, sub in tree.items() if sub}


# Flax's initializers (models/heads.py:24-25): normal(0.01) for the RPN
# conv/objectness and cls_score, normal(0.001) for the regressors.
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
    kernels, zero biases, identity FrozenBN.  CPU tensors."""
    from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector

    shapes = TwoStageDetector(cfg, device="meta").state_dict()
    out = {}
    with torch.no_grad():
        for key, t in shapes.items():
            value = torch.empty(t.shape, dtype=torch.float32)
            prefix, leaf = key.rsplit(".", 1)
            if f"{prefix}.var" in shapes:                  # FrozenBN constants
                value.fill_(1.0 if leaf in ("scale", "var") else 0.0)
            elif leaf == "bias":
                value.zero_()
            elif key in _NORMAL_STD:
                torch.nn.init.normal_(value, 0.0, _NORMAL_STD[key], generator=generator)
            else:
                fan_in = math.prod(t.shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                torch.nn.init.trunc_normal_(value, 0.0, std, -2.0 * std, 2.0 * std,
                                            generator=generator)
            out[key] = value
    return out
