"""In-graph target assignment and sampling (port of
``mx_rcnn_tpu/ops/sampling.py``).

:func:`assign_anchors` labels and subsamples RPN anchors; :func:`sample_rois`
draws the fixed R-CNN minibatch from the proposals plus the gt boxes.  The
batch axis is written out where the JAX code vmaps: every function takes
(B, ...) tensors and per-image sizes.

The random draws come in as arguments: uniform priorities in [0, 1),
``(B, A)`` for each of the two draws of :func:`assign_anchors` and
``(B, R + G)`` for each of the two of :func:`sample_rois`.  The JAX package
draws them with ``jax.random.uniform`` from threefry keys, which torch
cannot reproduce, so the parity tests hand the JAX draws to both packages;
the trainer draws them from a ``torch.Generator``.

Every discrete decision reads snapped IoUs (``geometry.snap``), takes ties
by the lower index (the stable ``ops/topk.py::top_k`` and stable
argsorts), and computes the sample order's priorities in float32 exactly
as the JAX code does, so that on the same draws the labels, masks and
sampled rows are bitwise those of the JAX package.  The speed-only tilings
of the JAX package (``assign_block``, ``topk_block``, ``roi_block``) are
bit-identical to the dense forms computed here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mx_rcnn_tpu_torch.geometry import encode_boxes, ioa_matrix, iou_matrix, snap
from mx_rcnn_tpu_torch.ops.topk import top_k

IGNORE_IOA = 0.5


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (B, A) int32: 1 fg, 0 bg, -1 ignore
    bbox_targets: torch.Tensor  # (B, A, 4) encode of the matched gt (fg rows)
    fg_mask: torch.Tensor       # (B, A) bool
    valid_mask: torch.Tensor    # (B, A) bool: labels != -1
    # The sampled minibatch in compact form, fg quota block then bg quota
    # block: anchor rows, whether a slot is a real sample, and whether it
    # is a fg sample.  Inactive slots hold an arbitrary row.
    sel_idx: torch.Tensor       # (B, Q) int32
    sel_take: torch.Tensor      # (B, Q) bool
    sel_fg: torch.Tensor        # (B, Q) bool


class RoiSamples(NamedTuple):
    rois: torch.Tensor           # (B, S, 4)
    labels: torch.Tensor         # (B, S) int32 class ids (0 = background)
    label_weights: torch.Tensor  # (B, S) 1.0 real sample, 0.0 padding
    bbox_targets: torch.Tensor   # (B, S, 4) encoded vs the roi (fg rows)
    fg_mask: torch.Tensor        # (B, S) bool
    gt_indices: torch.Tensor     # (B, S) int32 matched gt row (fg rows)


def _ignore_overlap_mask(boxes, gt_boxes, gt_ignore: Optional[torch.Tensor],
                         threshold: float = IGNORE_IOA) -> torch.Tensor:
    """(B, N) bool: a box has snapped IoA >= ``threshold`` with some
    ignore (crowd) region of its image."""
    if gt_ignore is None:
        return torch.zeros(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    ioa = snap(ioa_matrix(boxes, gt_boxes)) * gt_ignore[:, None, :].to(boxes.dtype)
    return torch.amax(ioa, dim=2) >= threshold


def _select_random(draw: torch.Tensor, candidate: torch.Tensor, n: torch.Tensor,
                   quota: int):
    """``n`` (B,) (at most ``quota``) uniform-random candidates per row:
    the ``quota`` largest priorities, non-candidates at -1, ties to the
    lower index.  -> (mask (B, A), idx (B, k), take (B, k))."""
    a = candidate.shape[1]
    n = torch.minimum(n, candidate.sum(dim=1))
    pri = torch.where(candidate, draw, -1.0)
    _, idx = top_k(pri, min(quota, a))
    take = torch.arange(idx.shape[1], device=idx.device)[None, :] < n[:, None]
    mask = torch.zeros_like(candidate).scatter_(1, idx, take)
    return mask, idx, take


def assign_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    image_hw: torch.Tensor,
    fg_draw: torch.Tensor,
    bg_draw: torch.Tensor,
    batch_size: int = 256,
    fg_fraction: float = 0.5,
    positive_iou: float = 0.7,
    negative_iou: float = 0.3,
    allowed_border: float = 0.0,
    gt_ignore: Optional[torch.Tensor] = None,
) -> AnchorTargets:
    """Label anchors (A, 4) for RPN training against gt (B, G, 4):

    - anchors crossing the image (by more than ``allowed_border``) ignored;
    - fg: IoU >= ``positive_iou`` with some gt, plus every gt's best inside
      anchor (ties included); bg: max IoU < ``negative_iou``, not fg, not
      covering an ignore region;
    - subsample to ``batch_size`` with at most ``fg_fraction`` positives,
      the leftover fg quota going to bg.

    ``image_hw`` (B, 2) are the true image sizes; ``fg_draw``/``bg_draw``
    (B, A) the uniform priorities.  The (B, A, G) IoU is dense."""
    h = image_hw[:, 0:1]
    w = image_hw[:, 1:2]
    inside = (
        (anchors[None, :, 0] >= -allowed_border)
        & (anchors[None, :, 1] >= -allowed_border)
        & (anchors[None, :, 2] < w + allowed_border)
        & (anchors[None, :, 3] < h + allowed_border)
    )                                                        # (B, A)
    gv = gt_valid[:, None, :]
    iou = snap(iou_matrix(anchors[None], gt_boxes)) * gv.to(anchors.dtype)  # (B, A, G)
    max_iou, argmax_gt = torch.max(iou, dim=2)
    iou_inside = iou * inside[..., None].to(iou.dtype)
    gt_best = torch.amax(iou_inside, dim=1, keepdim=True)   # (B, 1, G)
    # Exact == on snapped IoUs: ties are true ties.
    is_gt_best = torch.any((iou_inside == gt_best) & gv & (gt_best > 0.0), dim=2)
    del iou, iou_inside
    in_ignore = _ignore_overlap_mask(anchors[None].expand(gt_boxes.shape[0], -1, -1),
                                     gt_boxes, gt_ignore)

    any_gt = torch.any(gt_valid, dim=1, keepdim=True)
    fg_cand = inside & any_gt & ((max_iou >= positive_iou) | is_gt_best)
    bg_cand = inside & (max_iou < negative_iou) & ~fg_cand & ~in_ignore

    num_fg_quota = int(batch_size * fg_fraction)
    n_fg = torch.clamp(fg_cand.sum(dim=1), max=num_fg_quota)
    fg, fg_idx, fg_take = _select_random(fg_draw, fg_cand, n_fg, num_fg_quota)
    n_bg = torch.minimum(batch_size - n_fg, bg_cand.sum(dim=1))
    bg, bg_idx, bg_take = _select_random(bg_draw, bg_cand, n_bg, batch_size)

    labels = torch.full(fg.shape, -1, dtype=torch.int32, device=fg.device)
    labels = torch.where(bg, 0, labels)
    labels = torch.where(fg, 1, labels).to(torch.int32)

    matched = torch.gather(gt_boxes, 1, argmax_gt[..., None].expand(-1, -1, 4))
    bbox_targets = encode_boxes(matched, anchors[None])
    bbox_targets = torch.where(fg[..., None], bbox_targets, 0.0)
    return AnchorTargets(
        labels=labels,
        bbox_targets=bbox_targets,
        fg_mask=fg,
        valid_mask=labels >= 0,
        sel_idx=torch.cat([fg_idx, bg_idx], dim=1).to(torch.int32),
        sel_take=torch.cat([fg_take, bg_take], dim=1),
        sel_fg=torch.cat([fg_take, torch.zeros_like(bg_take)], dim=1),
    )


def _random_rank(draw: torch.Tensor, candidate: torch.Tensor) -> torch.Tensor:
    """Rank (B, N) int32 of each element under the random priorities,
    candidates first (non-candidates at 2.0 sort last), ties by index."""
    pri = torch.where(candidate, draw, 2.0)
    order = torch.argsort(pri, dim=1, stable=True)
    ar = torch.arange(order.shape[1], dtype=torch.int32, device=order.device)
    return torch.empty_like(order, dtype=torch.int32).scatter_(
        1, order, ar.expand_as(order).contiguous())


def sample_rois(
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_valid: torch.Tensor,
    fg_draw: torch.Tensor,
    bg_draw: torch.Tensor,
    batch_size: int = 512,
    fg_fraction: float = 0.25,
    fg_iou: float = 0.5,
    bg_iou_hi: float = 0.5,
    bg_iou_lo: float = 0.0,
    bbox_weights: tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
    gt_ignore: Optional[torch.Tensor] = None,
) -> RoiSamples:
    """The fixed R-CNN minibatch: gt boxes appended to the proposals
    (B, R, 4), each matched to gt by IoU snapped to 2**-8, fg (IoU >=
    ``fg_iou``) at most ``fg_fraction`` of ``batch_size``, bg in [lo, hi),
    compacted fg block, bg block, then zero-weight padding.  ``fg_draw``/
    ``bg_draw`` (B, R + G) are the uniform priorities."""
    all_rois = torch.cat([rois, gt_boxes], dim=1)            # (B, R+G, 4)
    all_valid = torch.cat([roi_valid, gt_valid], dim=1)
    iou = snap(iou_matrix(all_rois, gt_boxes), bits=8) * gt_valid[:, None, :].to(rois.dtype)
    row_max, argmax_gt = torch.max(iou, dim=2)
    max_iou = torch.where(all_valid, row_max, -1.0)
    in_ignore = _ignore_overlap_mask(all_rois, gt_boxes, gt_ignore)

    fg_cand = all_valid & (max_iou >= fg_iou)
    bg_cand = (all_valid & (max_iou < bg_iou_hi) & (max_iou >= bg_iou_lo)
               & ~fg_cand & ~in_ignore)

    num_fg_quota = int(batch_size * fg_fraction)
    fg_rank = _random_rank(fg_draw, fg_cand)
    n_fg = torch.clamp(fg_cand.sum(dim=1, keepdim=True), max=num_fg_quota)
    fg_sel = fg_cand & (fg_rank < n_fg)
    bg_rank = _random_rank(bg_draw, bg_cand)
    n_bg = torch.minimum(batch_size - n_fg, bg_cand.sum(dim=1, keepdim=True))
    bg_sel = bg_cand & (bg_rank < n_bg)

    # float32 priorities as the JAX code computes them: 3e9 - rank rounds
    # to multiples of 256, so the order inside a block comes from the
    # stable sort's index order, as it does in JAX.
    pri = torch.where(fg_sel, 3.0e9 - fg_rank.to(torch.float32),
                      torch.where(bg_sel, 1.0e9 - bg_rank.to(torch.float32), -1.0))
    order = torch.argsort(-pri, dim=1, stable=True)[:, :batch_size]
    picked = torch.gather(pri, 1, order) > 0.0

    out_rois = torch.gather(all_rois, 1, order[..., None].expand(-1, -1, 4))
    out_fg = torch.gather(fg_sel, 1, order)
    matched_gt = torch.gather(argmax_gt, 1, order)
    cls = torch.gather(gt_classes.to(torch.int32), 1, matched_gt)
    labels = torch.where(out_fg, cls, 0).to(torch.int32)
    matched_boxes = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(-1, -1, 4))
    targets = encode_boxes(matched_boxes, out_rois, weights=bbox_weights)
    targets = torch.where(out_fg[..., None], targets, 0.0)
    return RoiSamples(
        rois=out_rois,
        labels=labels,
        label_weights=picked.to(torch.float32),
        bbox_targets=targets,
        fg_mask=out_fg,
        gt_indices=matched_gt.to(torch.int32),
    )
