"""RPN proposal generation (port of ``mx_rcnn_tpu/ops/proposals.py``).

Decode RPN outputs into scored boxes, take the pre-NMS top-k per FPN
level, NMS, and emit a fixed ``post_nms_top_n`` roi set per image.  The
batch axis is written out where the JAX code vmaps over images; every
function here takes (B, ...) tensors and per-image sizes ``image_hw``
(B, 2) = (height, width).

Three middles, as in the JAX package:
  * fused (``fused_middle``): decode -> clip -> snap -> NMS in the CUDA
    kernel B3 (``ops/cuda/middle.py``), bitwise equal to the dense chain;
  * pallas-nms (``nms_impl="pallas"``): the dense decode with the keep
    mask from the CUDA NMS kernel B4, one launch per call over every
    (image, level) problem (the JAX package launches once per level,
    because the TPU grid runs in order);
  * dense (``nms_impl="xla"``): all plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mx_rcnn_tpu_torch.geometry import clip_boxes, decode_boxes, snap, valid_box_mask
from mx_rcnn_tpu_torch.ops.nms import nms_indices, rank_keep
from mx_rcnn_tpu_torch.ops.topk import top_k


class Proposals(NamedTuple):
    rois: torch.Tensor    # (B, post_nms_top_n, 4)
    scores: torch.Tensor  # (B, post_nms_top_n)
    valid: torch.Tensor   # (B, post_nms_top_n) bool


def _per_image(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (B,) per-image value shaped to broadcast over (B, ...) of ndim."""
    return x.reshape(-1, *([1] * (ndim - 1)))


def _topk_candidates(scores, deltas, anchors, pre_nms_top_n: int):
    """Score snap + pre-NMS top-k + candidate gather.

    scores (B, A), deltas (B, A, 4), anchors (A, 4) -> top scores (B, k),
    deltas (B, k, 4), anchors (B, k, 4) in score-descending,
    index-ascending-tie order (snapped scores make the order the same in
    every program; see geometry.snap)."""
    k = min(pre_nms_top_n, scores.shape[-1])
    top_scores, top_idx = top_k(snap(scores), k)
    top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(*top_idx.shape, 4))
    return top_scores, top_deltas, anchors[top_idx]


def decode_candidates(top_scores, top_deltas, top_anchors, image_hw, min_size: float):
    """Decode, clip, snap to 1/256 px and min-size mask top-k candidates
    (..., k) of B images -> (boxes (..., k, 4), scores masked to -inf)."""
    boxes = decode_boxes(top_deltas, top_anchors)
    nd = boxes.dim() - 1
    boxes = clip_boxes(
        boxes, _per_image(image_hw[:, 0], nd), _per_image(image_hw[:, 1], nd)
    )
    boxes = snap(boxes, bits=8)
    ok = valid_box_mask(boxes, min_size=min_size)
    return boxes, torch.where(ok, top_scores, -torch.inf)


def _pre_nms_candidates(scores, deltas, anchors, image_hw, pre_nms_top_n: int,
                        min_size: float):
    """Top-k by objectness, decode, clip and min-size mask: (boxes
    (B, k, 4), masked scores (B, k))."""
    return decode_candidates(
        *_topk_candidates(scores, deltas, anchors, pre_nms_top_n), image_hw, min_size
    )


def _stack_padded(parts, fill):
    """Stack per-level (B, k_l, ...) tensors on a new level axis 1, padding
    k_l up to the widest with ``fill``."""
    kmax = max(p.shape[1] for p in parts)
    out = []
    for p in parts:
        pad = kmax - p.shape[1]
        if pad:
            p = torch.cat([p, p.new_full((p.shape[0], pad, *p.shape[2:]), fill)], dim=1)
        out.append(p)
    return torch.stack(out, dim=1)


def generate_fpn_proposals(
    level_scores: dict[int, torch.Tensor],
    level_deltas: dict[int, torch.Tensor],
    level_anchors: dict[int, torch.Tensor],
    image_hw: torch.Tensor,
    pre_nms_top_n: int = 2000,
    post_nms_top_n: int = 1000,
    nms_threshold: float = 0.7,
    min_size: float = 0.0,
    nms_sweep_cap: int = 0,
    nms_impl: str = "xla",
    fused_middle: bool = False,
) -> Proposals:
    """FPN proposals: per-level top-k + NMS (each level may keep up to
    ``post_nms_top_n``), then the global top ``post_nms_top_n`` by score.

    level_scores {l: (B, A_l)}, level_deltas {l: (B, A_l, 4)},
    level_anchors {l: (A_l, 4)}; short levels are padded to the widest k
    with ``-inf`` scores, which neither keep nor suppress."""
    levels = sorted(level_scores)
    if fused_middle:
        from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels

        cand = [
            _topk_candidates(level_scores[l], level_deltas[l], level_anchors[l],
                             pre_nms_top_n)
            for l in levels
        ]
        sc_k = _stack_padded([s for s, _, _ in cand], -torch.inf).float()
        dl_k = _stack_padded([d for _, d, _ in cand], 0.0).float()
        an_k = _stack_padded([a for _, _, a in cand], 0.0).float()
        bx, sc, keep = fused_middle_levels(
            an_k, dl_k, sc_k, image_hw, min_size=min_size, iou_threshold=nms_threshold
        )
        keep_idx, keep_valid = rank_keep(keep, sc, post_nms_top_n)  # (B, L, post)
    else:
        cand = [
            _pre_nms_candidates(level_scores[l], level_deltas[l], level_anchors[l],
                                image_hw, pre_nms_top_n, min_size)
            for l in levels
        ]
        bx = _stack_padded([b for b, _ in cand], 0.0)       # (B, L, k, 4)
        sc = _stack_padded([s for _, s in cand], -torch.inf)  # (B, L, k)
        # The pallas branch is one NMS kernel launch over every (image,
        # level) problem; the padded lanes neither keep nor suppress, so
        # each keep mask is the same bits as a per-level launch's.
        keep_idx, keep_valid = nms_indices(
            bx, sc, nms_threshold, post_nms_top_n, sweep_cap=nms_sweep_cap,
            nms_impl=nms_impl,
        )
    rois_l = torch.gather(bx, 2, keep_idx[..., None].expand(*keep_idx.shape, 4))
    rois_l = rois_l * keep_valid[..., None]
    scores_l = torch.where(keep_valid, torch.gather(sc, 2, keep_idx), 0.0)

    b = image_hw.shape[0]
    rois = rois_l.reshape(b, -1, 4)
    scores = scores_l.reshape(b, -1)
    valid = keep_valid.reshape(b, -1)

    masked = torch.where(valid, scores, -torch.inf)
    top_scores, top_idx = top_k(masked, min(post_nms_top_n, rois.shape[1]))
    out_valid = torch.isfinite(top_scores)
    out_rois = torch.gather(rois, 1, top_idx[..., None].expand(*top_idx.shape, 4))
    return Proposals(
        rois=out_rois * out_valid[..., None],
        scores=torch.where(out_valid, top_scores, 0.0),
        valid=out_valid,
    )
