"""Static-shape non-maximum suppression (port of ``mx_rcnn_tpu/ops/nms.py``).

Score-sort, build the strictly upper-triangular suppression matrix from
the 2**-16-snapped IoU, then iterate

    keep[i] <- valid[i] and not OR_{j<i} (keep[j] and suppress[j, i])

to a fixed point.  Any fixed point of this map is the greedy-NMS solution,
and each sweep finalizes at least one undecided box.  Every function takes
leading batch axes (``...``) where the JAX version is vmapped.

This file is plain torch on every device: the JAX package runs it as XLA
code, not as a Pallas kernel.  ``nms_impl="pallas"`` routes the keep mask
through the CUDA kernel that replaces the Pallas NMS (``ops/cuda/nms.py``).
"""

from __future__ import annotations

import torch

from mx_rcnn_tpu_torch.geometry import iou_matrix, snap


def greedy_fixed_point(
    suppress: torch.Tensor, valid: torch.Tensor, sweep_cap: int = 0
) -> torch.Tensor:
    """Iterate the greedy recurrence over a (..., N, N) suppression matrix
    in sorted order; returns the (..., N) keep mask in that order.

    ``sweep_cap > 0`` bounds the sweeps (exact for any cap >= N).  Lanes
    that converge early are fixed points, so further sweeps leave them."""
    keep, prev = valid, torch.zeros_like(valid)
    sweeps = 0
    while not torch.equal(keep, prev) and (sweep_cap <= 0 or sweeps < sweep_cap):
        new = valid & ~torch.any(suppress & keep[..., :, None], dim=-2)
        keep, prev = new, keep
        sweeps += 1
    return keep


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    sweep_cap: int = 0,
) -> torch.Tensor:
    """Greedy NMS keep mask in input order.

    boxes (..., N, 4), scores (..., N); entries with ``-inf`` score or a
    false ``valid`` neither keep nor suppress.  The sort is stable, so
    ties go to the lower index as in ``jnp.argsort``."""
    n = boxes.shape[-2]
    finite = torch.isfinite(scores)
    valid = finite if valid is None else valid & finite
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(valid, -1, order)

    iou = snap(iou_matrix(sboxes, sboxes))
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (
        (iou > iou_threshold) & upper & svalid[..., :, None] & svalid[..., None, :]
    )
    keep_sorted = greedy_fixed_point(suppress, svalid, sweep_cap)
    return torch.zeros_like(svalid).scatter(-1, order, keep_sorted)


def rank_keep(keep: torch.Tensor, scores: torch.Tensor, max_outputs: int):
    """Rank a keep mask by score into up to ``max_outputs`` indices: kept
    entries first, best score first; padded slots index 0, not valid."""
    n = keep.shape[-1]
    neg = torch.where(keep, -scores, torch.inf)
    order = torch.argsort(neg, dim=-1, stable=True)
    k = min(n, max_outputs)
    idx = order[..., :k]
    kept = torch.gather(keep, -1, idx)
    if k < max_outputs:
        pad = max_outputs - k
        idx = torch.cat([idx, idx.new_zeros(*idx.shape[:-1], pad)], dim=-1)
        kept = torch.cat([kept, kept.new_zeros(*kept.shape[:-1], pad)], dim=-1)
    slots = torch.arange(max_outputs, device=keep.device)
    out_valid = kept & (slots < keep.sum(-1, keepdim=True))
    return torch.where(out_valid, idx, 0), out_valid


def nms_indices(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    valid: torch.Tensor | None = None,
    sweep_cap: int = 0,
    nms_impl: str = "xla",
):
    """NMS returning ``(indices (..., max_outputs), out_valid)``,
    score-descending.  ``nms_impl="pallas"`` takes the keep mask from the
    CUDA NMS kernel (always exact greedy, so ``sweep_cap`` does not apply);
    ``"xla"`` from the fixed point above."""
    if nms_impl == "pallas":
        from mx_rcnn_tpu_torch.ops.cuda.nms import nms_mask_cuda

        keep = nms_mask_cuda(boxes, scores, iou_threshold, valid)
    elif nms_impl == "xla":
        keep = nms_mask(boxes, scores, iou_threshold, valid, sweep_cap=sweep_cap)
    else:
        raise ValueError(f"nms_impl must be 'xla' or 'pallas', got {nms_impl!r}")
    return rank_keep(keep, scores, max_outputs)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
    sweep_cap: int = 0,
) -> torch.Tensor:
    """Per-class NMS in one pass: boxes (..., N, 4) of different classes
    are translated to disjoint regions, one span per problem."""
    span = boxes.amax(dim=(-2, -1)) - boxes.amin(dim=(-2, -1)) + 1.0
    offset = classes.to(boxes.dtype)[..., None] * span[..., None, None]
    return nms_mask(boxes + offset, scores, iou_threshold, valid, sweep_cap=sweep_cap)
