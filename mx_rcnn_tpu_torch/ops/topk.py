"""Exact top-k with the tie order of ``lax.top_k`` (port of
``mx_rcnn_tpu/ops/topk.py``).

``lax.top_k`` orders by (value desc, index asc): the lower index wins a
tie, and ``hierarchical_top_k`` is bit-identical to it.  ``torch.topk``
promises no tie order, so the port takes a stable descending sort and
slices it.  Under the ``"mixed"`` policy the RPN scores are bf16 and then
snapped, so ties are everywhere, and the fused middle's exactness rests on
this order (``ops/cuda/middle.py``).
"""

from __future__ import annotations

import torch


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, value-descending with index-ascending ties."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds operand size {scores.shape[-1]}")
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
