"""Detection losses (port of ``mx_rcnn_tpu/geometry/losses.py``).

:func:`masked_softmax_cross_entropy` is the reference's
``SoftmaxOutput(use_ignore, normalization='valid')``; :func:`smooth_l1` and
:func:`weighted_smooth_l1` its sigma-parameterized ``smooth_l1`` with
inside weights.  Shape-polymorphic over leading axes; every reduction sums
in the input dtype (the callers upcast to float32 first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    valid_mask: torch.Tensor,
) -> torch.Tensor:
    """Softmax CE over the last axis; entries with ``valid_mask == 0``
    contribute zero loss and zero gradient.  Normalized by the valid
    count (at least 1)."""
    valid = valid_mask.to(logits.dtype)
    safe_labels = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    return torch.sum(ce * valid) / torch.clamp(torch.sum(valid), min=1.0)


def smooth_l1(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """0.5 * (sigma * x)**2 if |x| < 1 / sigma**2 else |x| - 0.5 / sigma**2."""
    s2 = sigma * sigma
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def weighted_smooth_l1(
    pred: torch.Tensor,
    target: torch.Tensor,
    inside_weight: torch.Tensor,
    sigma: float = 1.0,
    normalizer: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """``sum(smooth_l1((pred - target) * inside_weight)) / max(normalizer, 1)``."""
    loss = smooth_l1((pred - target) * inside_weight, sigma=sigma)
    return torch.sum(loss) / torch.clamp(torch.as_tensor(normalizer, dtype=loss.dtype,
                                                         device=loss.device), min=1.0)
