"""Inference computations of the two-stage detector (port of the inference
half of ``mx_rcnn_tpu/detection/graph.py``).

Every function takes the whole batch: where the JAX graph vmaps a
per-image function, the batch axis is written out.  The model is a
:class:`~mx_rcnn_tpu_torch.detection.detector.TwoStageDetector` holding its
weights; call these under ``torch.inference_mode()``.

Shape conventions: B = batch, A = anchors over levels, R = proposals per
image, S = pooled size, C = classes including background 0.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import ModelConfig
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.geometry import (
    clip_boxes,
    decode_boxes,
    generate_base_anchors,
    shifted_anchors_np,
)
from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_cuda
from mx_rcnn_tpu_torch.ops.nms import batched_nms
from mx_rcnn_tpu_torch.ops.proposals import Proposals, generate_fpn_proposals
from mx_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align
from mx_rcnn_tpu_torch.ops.topk import top_k


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4) in input-image coordinates
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int32, 1-based foreground ids
    valid: torch.Tensor    # (B, D) bool


@lru_cache(maxsize=64)
def _cached_level_anchor(stride: int, ratios, scales, h: int, w: int,
                         device: torch.device) -> torch.Tensor:
    """One level's anchor grid, computed in host numpy (float64 math,
    float32 out) and kept on ``device``.  Nothing writes to it."""
    base = generate_base_anchors(base_size=stride, ratios=ratios, scales=scales)
    return torch.tensor(shifted_anchors_np(base, stride, h, w), device=device)


def level_anchors(cfg: ModelConfig, feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
    """Per-level anchor grids (A_l, 4) for NHWC features, on their device."""
    out = {}
    for lvl in sorted(feats):
        _, h, w, _ = feats[lvl].shape
        out[lvl] = _cached_level_anchor(
            2**lvl, tuple(cfg.anchors.ratios), tuple(cfg.anchors.scales), h, w,
            feats[lvl].device,
        )
    return out


def prep_images(images: torch.Tensor, pixel_stats=None) -> torch.Tensor:
    """uint8 images -> (x - mean) * (1/std) in float32, the reciprocal
    taken in float32 as the JAX graph does; float32 images pass through."""
    if images.dtype != torch.uint8:
        return images
    if pixel_stats is None:
        raise ValueError("uint8 Batch.images need pixel_stats=(mean, std)")
    mean = torch.tensor(np.asarray(pixel_stats[0], np.float32), device=images.device)
    inv_std = torch.tensor(
        np.float32(1.0) / np.asarray(pixel_stats[1], np.float32), device=images.device
    )
    return (images.to(torch.float32) - mean) * inv_std


def _propose_one(cfg: ModelConfig):
    """The proposal function over per-level RPN outputs of the batch.

    ``rpn.fused_middle`` selects the fused CUDA middle (kernel B3),
    ``rpn.nms_impl="pallas"`` the CUDA NMS kernel (B4) under the dense
    decode, ``"xla"`` the plain torch chain.  On CPU tensors the kernels'
    wrappers take their plain versions."""
    rpn = cfg.rpn
    if rpn.nms_impl not in ("xla", "pallas"):
        raise ValueError(f"rpn.nms_impl must be 'xla' or 'pallas', got {rpn.nms_impl!r}")

    def propose(level_scores, level_deltas, level_anchor, image_hw) -> Proposals:
        if len(level_scores) == 1:
            raise NotImplementedError("single-level (C4) proposals are not ported")
        return generate_fpn_proposals(
            level_scores, level_deltas, level_anchor, image_hw,
            pre_nms_top_n=rpn.test_pre_nms_top_n,
            post_nms_top_n=rpn.test_post_nms_top_n,
            nms_threshold=rpn.nms_threshold, min_size=rpn.min_size,
            nms_sweep_cap=rpn.nms_sweep_cap, nms_impl=rpn.nms_impl,
            fused_middle=rpn.fused_middle,
        )

    return propose


def _slice_levels(levels, anchors, scores, deltas):
    """Split concatenated (B, A) / (B, A, 4) rows back into per-level
    dicts, paired with each level's anchor grid."""
    off = 0
    s_lvls, d_lvls, a_lvls = {}, {}, {}
    for l in levels:
        n = anchors[l].shape[0]
        s_lvls[l] = scores[:, off:off + n]
        d_lvls[l] = deltas[:, off:off + n]
        a_lvls[l] = anchors[l]
        off += n
    return s_lvls, d_lvls, a_lvls


def _pool_rois_impl(cfg: ModelConfig, feats, rois, pooled_size: int, roi_level_set):
    """ROIAlign over the batch: rois (B, R, 4) -> (B, R, S, S, C).
    ``rcnn.roi_align_impl="pallas"`` takes CUDA kernel B1, ``"xla"`` the
    plain gather."""
    impl = cfg.rcnn.roi_align_impl
    if impl not in ("xla", "pallas"):
        raise ValueError(f"rcnn.roi_align_impl must be 'xla' or 'pallas', got {impl!r}")
    roi_levels = {l: f for l, f in feats.items() if l in roi_level_set}
    if len(roi_levels) < 2:
        raise NotImplementedError("single-level (C4) ROIAlign is not ported")
    pool = multilevel_roi_align_cuda if impl == "pallas" else multilevel_roi_align
    return pool(roi_levels, rois, pooled_size, cfg.rcnn.sampling_ratio)


def _propose_on_features(model, feats, batch: Batch) -> Proposals:
    """Shared RPN -> proposals front end of inference and RPN-only serving."""
    cfg = model.cfg
    rpn_out = model.rpn(feats)
    anchors = level_anchors(cfg, feats)
    levels = sorted(rpn_out)
    logits = torch.cat([rpn_out[l][0] for l in levels], dim=1)
    deltas = torch.cat([rpn_out[l][1] for l in levels], dim=1)
    scores = torch.sigmoid(logits)
    propose = _propose_one(cfg)
    return propose(*_slice_levels(levels, anchors, scores, deltas), batch.image_hw)


def forward_inference(model, batch: Batch, pixel_stats=None) -> Detections:
    """Full inference: backbone -> RPN -> proposals -> ROIAlign -> box
    head -> fused class-offset NMS -> top-D, padded with a valid mask."""
    cfg = model.cfg
    if cfg.test.nms_mode == "per_class":
        raise NotImplementedError("test.nms_mode='per_class' is not ported")
    if cfg.test.nms_mode != "fused":
        raise ValueError(f"test.nms_mode must be 'per_class' or 'fused', got {cfg.test.nms_mode!r}")
    feats = model.features(prep_images(batch.images, pixel_stats))
    props = _propose_on_features(model, feats, batch)
    pooled = _pool_rois_impl(cfg, feats, props.rois, cfg.rcnn.pooled_size, model.roi_levels)
    s = cfg.rcnn.pooled_size
    cls_logits, box_deltas = model.box(pooled.reshape(-1, s, s, pooled.shape[-1]))

    b, r = props.rois.shape[:2]
    # Scores and box coordinates stay float32 through postprocess whatever
    # the heads emit.
    cls_prob = torch.softmax(cls_logits.float(), dim=-1).reshape(b, r, cfg.num_classes)
    box_deltas = box_deltas.float().reshape(b, r, -1, 4)
    return Detections(*_postprocess_one_fused(
        cfg, props.rois, props.valid, cls_prob, box_deltas, batch.image_hw
    ))


def forward_proposals(model, batch: Batch, pixel_stats=None) -> Proposals:
    """RPN-only inference: backbone -> RPN -> proposals (scores in f32)."""
    feats = model.features(prep_images(batch.images, pixel_stats))
    props = _propose_on_features(model, feats, batch)
    return props._replace(scores=props.scores.float())


def _postprocess_one_fused(cfg: ModelConfig, rois, roi_valid, probs, deltas, image_hw):
    """Fused postprocess over the batch: global top-K (roi, class)
    candidates by score, decode, ONE class-offset NMS, top-D.

    rois (B, R, 4), roi_valid (B, R), probs (B, R, C), deltas
    (B, R, C or 1, 4), image_hw (B, 2) -> boxes (B, D, 4), scores (B, D),
    classes (B, D) int32, valid (B, D)."""
    b, r = rois.shape[:2]
    d_out = cfg.test.max_detections
    fg = cfg.num_classes - 1
    k = min(r * fg, cfg.test.fused_top_k)

    sc = torch.where(
        roi_valid[..., None] & (probs[..., 1:] >= cfg.test.score_threshold),
        probs[..., 1:],
        -torch.inf,
    )                                                   # (B, R, C-1)
    top_s, top_i = top_k(sc.reshape(b, -1), k)          # flat id = roi*fg + (c-1)
    roi_i = top_i // fg
    cls = top_i % fg + 1

    cand_rois = torch.gather(rois, 1, roi_i[..., None].expand(b, k, 4))
    bi = torch.arange(b, device=rois.device)[:, None]
    delta_sel = deltas[bi, roi_i, 0] if cfg.rcnn.class_agnostic else deltas[bi, roi_i, cls]
    boxes = decode_boxes(delta_sel, cand_rois, weights=cfg.rcnn.bbox_weights)
    boxes = clip_boxes(boxes, image_hw[:, 0:1], image_hw[:, 1:2])

    keep = batched_nms(boxes, top_s, cls, cfg.test.nms_threshold,
                       valid=torch.isfinite(top_s), sweep_cap=cfg.test.nms_sweep_cap)
    kept_s = torch.where(keep, top_s, -torch.inf)
    out_s, out_i = top_k(kept_s, min(d_out, k))
    if k < d_out:
        pad = d_out - k
        out_s = torch.cat([out_s, out_s.new_full((b, pad), -torch.inf)], dim=1)
        out_i = torch.cat([out_i, out_i.new_zeros((b, pad))], dim=1)
    valid = torch.isfinite(out_s)
    out_boxes = torch.gather(boxes, 1, out_i[..., None].expand(b, d_out, 4))
    return (
        out_boxes * valid[..., None],
        torch.where(valid, out_s, 0.0),
        torch.where(valid, torch.gather(cls, 1, out_i), 0).to(torch.int32),
        valid,
    )
