"""Mixed-precision policy (port of ``mx_rcnn_tpu/utils/precision.py``).

Three regions, one dtype each: ``compute_dtype`` for conv/matmul inside
the model, ``output_dtype`` for what the heads emit, ``accum_dtype`` for
sums.  Parameters stay float32 masters and are cast to the compute dtype
at each use, as flax does.  Box coordinates, the inference softmax and
the postprocess deltas stay float32 (detection/graph.py).  The port
writes every cast out; it never uses autocast.

=========  =============  ============  ===========
policy     compute        output        accum
=========  =============  ============  ===========
mixed      backbone.dtype compute       float32
widen      backbone.dtype float32       float32
float32    float32        float32       float32
=========  =============  ============  ===========
"""

from __future__ import annotations

import dataclasses

import torch

_NAMED = {"bfloat16": torch.bfloat16, "float32": torch.float32}

POLICIES = ("mixed", "widen", "float32")


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    compute_dtype: torch.dtype
    output_dtype: torch.dtype
    accum_dtype: torch.dtype
    param_dtype: torch.dtype = torch.float32


def resolve(policy: str, backbone_dtype: str, accum: str = "float32") -> Policy:
    """Resolve a named policy against the backbone compute-dtype knob."""
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r}; one of {POLICIES}")
    if backbone_dtype not in _NAMED:
        raise ValueError(f"unknown dtype {backbone_dtype!r}")
    if accum not in _NAMED:
        raise ValueError(f"unknown accum dtype {accum!r}")
    compute = torch.float32 if policy == "float32" else _NAMED[backbone_dtype]
    output = compute if policy == "mixed" else torch.float32
    return Policy(
        name=policy,
        compute_dtype=compute,
        output_dtype=output,
        accum_dtype=_NAMED[accum],
    )


def policy_of(model_cfg) -> Policy:
    """The policy of a ``config.ModelConfig``."""
    prec = model_cfg.precision
    return resolve(prec.policy, model_cfg.backbone.dtype, prec.accum)


# ---------------------------------------------------------------------------
# int8 weight-only quantization (serving)
# ---------------------------------------------------------------------------


def quantize_per_channel(w: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 quantization along ``axis`` (the output
    channel): q = round(w / s), rounding half to even, s = amax(|w|) / 127
    per channel.  Returns ``(q int8, scale f32)`` with ``scale`` shaped to
    broadcast against ``q``.  Zero channels get scale 1 so dequantization
    stays exact.  The JAX package's numerics, element for element."""
    w = w.to(torch.float32)
    axis = axis % w.ndim
    amax = w.abs().amax(dim=tuple(i for i in range(w.ndim) if i != axis), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """int8 weights back to ``dtype``: the scale multiply in f32, then one
    cast."""
    return (q.to(torch.float32) * scale).to(dtype)
