"""int8 weight-only PTQ for serving (port of ``mx_rcnn_tpu/serve/quantize.py``),
in the port's ``state_dict`` layout.

Two surfaces, one numerics (symmetric per-output-channel int8 with f32
scales, ``utils/precision.py``), each quantized on the host from the f32
masters so that ``q`` and ``scale`` are bitwise the JAX package's after
``weights.py``'s conversion:

* **Box head** (:func:`quantize_box_head` / :func:`apply_box_head_q8`),
  the ``full_q8`` level: the four BoxHead Dense weights (fc6, fc7,
  cls_score, bbox_pred) become int8 with f32 biases.  Each dense layer
  dequantizes to bf16, multiplies bf16 x bf16 with an f32 result, adds the
  f32 bias and applies ReLU on the f32 result; logits and deltas come out
  f32.  The compute dtype is bf16 whatever the model's policy, as in JAX.
* **Whole network** (:func:`quantize_network` / :func:`dequantize_network`),
  the ``full_q8n`` level: every parameter named ``weight`` with two or
  more axes (convolutions, FPN, RPN head, box and mask heads) becomes a
  ``{"q", "scale"}`` pair along its output-channel axis: 0 for Dense
  (out, in) and Conv2d (O, I, k, k), 1 for the mask head's
  ConvTranspose2d (I, O, k, k) (``weights.py::output_axis``).  Biases and
  the FrozenBN buffers pass through.  :func:`dequantize_network` rebuilds
  f32 masters (one f32 product of ``q`` and its channel scale, as in JAX),
  which the layers cast to their compute dtype as they cast any master, so
  the ``full_q8n`` program is the production forward with rounded weights.
"""

from __future__ import annotations

from typing import Any

import torch

from mx_rcnn_tpu_torch.utils.precision import dequantize, quantize_per_channel
from mx_rcnn_tpu_torch.weights import is_constant, output_axis

# The BoxHead Dense layers, in application order (models/heads.py).
QUANT_LAYERS = ("fc6", "fc7", "cls_score", "bbox_pred")


def quantize_box_head(state_dict) -> dict:
    """Quantize the box head's Dense weights out of a ``state_dict``:
    ``{layer: {"q": int8 (out, in), "scale": f32 (out, 1), "bias": f32
    (out,)}}``."""
    out = {}
    for name in QUANT_LAYERS:
        q, scale = quantize_per_channel(state_dict[f"box_head.{name}.weight"], axis=0)
        out[name] = {"q": q, "scale": scale,
                     "bias": state_dict[f"box_head.{name}.bias"].to(torch.float32)}
    return out


def apply_box_head_q8(qtree: dict, pooled: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16):
    """The int8/bf16 box head (``BoxHead.forward``'s contract): pooled
    (R, S, S, C) -> f32 logits (R, num_classes), f32 deltas (R, n_reg, 4).

    Each product of two bf16 values is exact in f32 (and in TF32), so an f32
    matmul of the bf16-rounded operands is the bf16 x bf16 dot with an f32
    result."""

    def dense(x: torch.Tensor, name: str) -> torch.Tensor:
        layer = qtree[name]
        w = dequantize(layer["q"], layer["scale"], compute_dtype)
        y = torch.matmul(x.to(compute_dtype).float(), w.float().t())
        return y + layer["bias"]

    r = pooled.shape[0]
    x = pooled.reshape(r, -1)
    x = torch.relu(dense(x, "fc6"))
    x = torch.relu(dense(x, "fc7"))
    logits = dense(x, "cls_score")
    deltas = dense(x, "bbox_pred")
    return logits, deltas.reshape(r, -1, 4)


def is_quantized_leaf(x: Any) -> bool:
    """True for the ``{"q": int8, "scale": f32}`` pairs that
    :func:`quantize_network` puts in place of weights."""
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def quantize_network(state_dict) -> dict:
    """Whole-network weight-only PTQ: every parameter named ``weight`` with
    ndim >= 2 becomes ``{"q": int8, "scale": f32}`` along its output axis;
    every other tensor (biases, FrozenBN buffers) passes through.  Same keys
    as ``state_dict``."""
    out = {}
    for key, value in state_dict.items():
        if key.endswith(".weight") and value.ndim >= 2 and not is_constant(key, state_dict):
            q, scale = quantize_per_channel(value, axis=output_axis(key))
            out[key] = {"q": q, "scale": scale}
        else:
            out[key] = value
    return out


def dequantize_network(qnet: dict, dtype: torch.dtype = torch.float32) -> dict:
    """The inverse of :func:`quantize_network`: a ``state_dict`` the model
    can run, each quantized weight rebuilt in ``dtype``."""
    return {k: dequantize(v["q"], v["scale"], dtype) if is_quantized_leaf(v) else v
            for k, v in qnet.items()}
