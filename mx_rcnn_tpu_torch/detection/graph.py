"""Train and inference computations of the two-stage detector (port of
``mx_rcnn_tpu/detection/graph.py``).

Every function takes the whole batch: where the JAX graph vmaps a
per-image function, the batch axis is written out.  The model is a
:class:`~mx_rcnn_tpu_torch.detection.detector.TwoStageDetector` holding its
weights; call the inference functions under ``torch.inference_mode()``.
:func:`forward_train` returns the differentiable total loss; its random
draws come in as :class:`Draws`, a microbatch's rows of a
:class:`BatchDraws` or a ``torch.Generator``.  A batch with
``ext_rois`` runs Fast R-CNN mode: training samples the external
proposals in place of the RPN's (and drops the RPN from the graph when
``rpn.loss_weight`` is 0), inference scores them.  With ``mask.enabled``
(Mask R-CNN) training pools the sampled fg rois a second time at
``mask.pooled_size`` through the same ROIAlign (kernels B1 and B2) and
adds the mask loss, and inference pools the final detections for their
masks.  One feature level (the C4 recipe) takes the single-level
proposals and ROIAlign; several, the FPN ones.

Shape conventions: B = batch, G = max gt boxes, A = anchors over levels,
R = proposals per image, S = pooled size, C = classes including
background 0.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mx_rcnn_tpu_torch.config import ModelConfig
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.geometry import (
    clip_boxes,
    decode_boxes,
    generate_base_anchors,
    shifted_anchors_np,
)
from mx_rcnn_tpu_torch.geometry.losses import masked_softmax_cross_entropy, weighted_smooth_l1
from mx_rcnn_tpu_torch.ops.cuda.roi_align import multilevel_roi_align_fast
from mx_rcnn_tpu_torch.ops.nms import batched_nms, nms_indices
from mx_rcnn_tpu_torch.ops.proposals import Proposals, generate_fpn_proposals, generate_proposals
from mx_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align, roi_align
from mx_rcnn_tpu_torch.ops.sampling import AnchorTargets, RoiSamples, assign_anchors, sample_rois
from mx_rcnn_tpu_torch.ops.topk import top_k


class Detections(NamedTuple):
    boxes: torch.Tensor    # (B, D, 4) in input-image coordinates
    scores: torch.Tensor   # (B, D)
    classes: torch.Tensor  # (B, D) int32, 1-based foreground ids
    valid: torch.Tensor    # (B, D) bool
    # (B, D, M, M) mask probabilities of each detection's class (Mask R-CNN)
    masks: Optional[torch.Tensor] = None


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


def _propose_one(cfg: ModelConfig, train: bool = False):
    """The proposal function over per-level RPN outputs of the batch, with
    the train or test pre/post-NMS top-n.

    ``rpn.fused_middle`` selects the fused CUDA middle (kernel B3),
    ``rpn.nms_impl="pallas"`` the CUDA NMS kernel (B4) under the dense
    decode, ``"xla"`` the plain torch chain.  On CPU tensors the kernels'
    wrappers take their plain versions."""
    rpn = cfg.rpn
    pre = rpn.train_pre_nms_top_n if train else rpn.test_pre_nms_top_n
    post = rpn.train_post_nms_top_n if train else rpn.test_post_nms_top_n
    if rpn.nms_impl not in ("xla", "pallas"):
        raise ValueError(f"rpn.nms_impl must be 'xla' or 'pallas', got {rpn.nms_impl!r}")

    def propose(level_scores, level_deltas, level_anchor, image_hw) -> Proposals:
        kw = dict(pre_nms_top_n=pre, post_nms_top_n=post, nms_threshold=rpn.nms_threshold,
                  min_size=rpn.min_size, nms_sweep_cap=rpn.nms_sweep_cap,
                  nms_impl=rpn.nms_impl, fused_middle=rpn.fused_middle)
        if len(level_scores) == 1:
            (s,), (d,), (a,) = (level_scores.values(), level_deltas.values(),
                                level_anchor.values())
            return generate_proposals(s, d, a, image_hw, **kw)
        return generate_fpn_proposals(level_scores, level_deltas, level_anchor, image_hw, **kw)

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

    ``rcnn.roi_align_impl="pallas"`` takes CUDA kernel B1 inside the
    autograd ``Function`` whose backward ``rcnn.roi_align_bwd_impl`` picks
    (``"pallas"`` kernel B2, ``"xla"`` autograd of the plain forward), or
    B1 alone when grad mode is off; ``"xla"`` the plain gather,
    differentiated by autograd.  A single level (the C4 recipe) takes the
    kernels too, over the one-level pyramid, where the JAX package takes
    its XLA gather: B1 stages no window, so a roi may span the map, and on
    one level the two compute the same bits (``ops/roi_align.py``)."""
    impl, bwd = cfg.rcnn.roi_align_impl, cfg.rcnn.roi_align_bwd_impl
    if impl not in ("xla", "pallas"):
        raise ValueError(f"rcnn.roi_align_impl must be 'xla' or 'pallas', got {impl!r}")
    if bwd not in ("xla", "pallas"):
        raise ValueError(f"rcnn.roi_align_bwd_impl must be 'xla' or 'pallas', got {bwd!r}")
    roi_levels = {l: f for l, f in feats.items() if l in roi_level_set}
    sr = cfg.rcnn.sampling_ratio
    if impl == "xla":
        if len(roi_levels) == 1:
            (lvl, f), = roi_levels.items()
            return roi_align(f, rois, pooled_size, 1.0 / 2**lvl, sr)
        return multilevel_roi_align(roi_levels, rois, pooled_size, sr)
    return multilevel_roi_align_fast(roi_levels, rois, pooled_size, sr, bwd)


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


def _check_ext(batch: Batch) -> bool:
    """Whether the batch carries external proposals (with their mask)."""
    if batch.ext_rois is None:
        return False
    if batch.ext_valid is None:
        raise ValueError("Batch.ext_rois requires ext_valid (pad mask)")
    return True


def forward_inference(model, batch: Batch, pixel_stats=None, box_head_apply=None) -> Detections:
    """Full inference: backbone -> RPN -> proposals -> ROIAlign -> box
    head -> NMS (``test.nms_mode``: fused class-offset or per class) ->
    top-D, padded with a valid mask; with ``mask.enabled`` each of the D
    slots also gets the sigmoid of its class's mask logits
    (``Detections.masks``).  A batch with ``ext_rois`` skips the
    RPN and scores those rois (Fast R-CNN testing, the reference's
    ``test_rcnn --has_rpn false``).  ``box_head_apply(pooled) -> (logits,
    deltas)`` replaces ``model.box`` (serving's int8 head,
    ``serve/quantize.py::apply_box_head_q8``)."""
    cfg = model.cfg
    post = {"fused": _postprocess_one_fused, "per_class": _postprocess_one}.get(cfg.test.nms_mode)
    if post is None:
        raise ValueError(f"test.nms_mode must be 'per_class' or 'fused', got {cfg.test.nms_mode!r}")
    feats = model.features(prep_images(batch.images, pixel_stats))
    if _check_ext(batch):
        props = Proposals(rois=batch.ext_rois, valid=batch.ext_valid,
                          scores=torch.zeros(batch.ext_valid.shape, dtype=torch.float32,
                                             device=batch.ext_valid.device))
    else:
        props = _propose_on_features(model, feats, batch)
    pooled = _pool_rois_impl(cfg, feats, props.rois, cfg.rcnn.pooled_size, model.roi_levels)
    s = cfg.rcnn.pooled_size
    box = model.box if box_head_apply is None else box_head_apply
    cls_logits, box_deltas = box(pooled.reshape(-1, s, s, pooled.shape[-1]))

    b, r = props.rois.shape[:2]
    # Scores and box coordinates stay float32 through postprocess whatever
    # the heads emit.
    cls_prob = torch.softmax(cls_logits.float(), dim=-1).reshape(b, r, cfg.num_classes)
    box_deltas = box_deltas.float().reshape(b, r, -1, 4)
    dets = Detections(*post(cfg, props.rois, props.valid, cls_prob, box_deltas, batch.image_hw))
    if cfg.mask.enabled:
        # Boxes first, then one mask a detection slot, valid or not.
        own = _own_class(_mask_logits(model, feats, dets.boxes), dets.classes)
        dets = dets._replace(masks=torch.sigmoid(own))
    return dets


def forward_proposals(model, batch: Batch, pixel_stats=None) -> Proposals:
    """RPN-only inference: backbone -> RPN -> proposals (scores in f32)."""
    feats = model.features(prep_images(batch.images, pixel_stats))
    props = _propose_on_features(model, feats, batch)
    return props._replace(scores=props.scores.float())


def _postprocess_one(cfg: ModelConfig, rois, roi_valid, probs, deltas, image_hw):
    """Per-class postprocess over the batch: decode every roi per
    foreground class, threshold, top ``per_class_k`` per class, one NMS
    per class, global top-D.  The C-1 classes are one batched problem
    (the JAX graph's vmap over classes), never a loop.

    rois (B, R, 4), roi_valid (B, R), probs (B, R, C), deltas
    (B, R, C or 1, 4), image_hw (B, 2) -> boxes (B, D, 4), scores (B, D),
    classes (B, D) int32, valid (B, D)."""
    b, r = rois.shape[:2]
    d_out = cfg.test.max_detections
    fg = cfg.num_classes - 1
    per_class_k = min(r, max(2 * d_out, 100))

    # (B, C-1, R, ...): class c-1 on axis 1.
    delta_c = deltas[:, :, :1] if cfg.rcnn.class_agnostic else deltas[:, :, 1:]
    delta_c = delta_c.expand(b, r, fg, 4).permute(0, 2, 1, 3)
    boxes = decode_boxes(delta_c, rois[:, None], weights=cfg.rcnn.bbox_weights)
    boxes = clip_boxes(boxes, image_hw[:, 0, None, None], image_hw[:, 1, None, None])
    p = probs[..., 1:].permute(0, 2, 1)
    sc = torch.where(roi_valid[:, None] & (p >= cfg.test.score_threshold), p, -torch.inf)
    top_s, top_i = top_k(sc, per_class_k)                       # (B, C-1, K)
    top_b = torch.gather(boxes, 2, top_i[..., None].expand(*top_i.shape, 4))
    keep_i, keep_v = nms_indices(top_b, top_s, cfg.test.nms_threshold, per_class_k,
                                 sweep_cap=cfg.test.nms_sweep_cap)
    out_b = torch.gather(top_b, 2, keep_i[..., None].expand(*keep_i.shape, 4))
    out_s = torch.where(keep_v, torch.gather(top_s, 2, keep_i), -torch.inf)

    flat_b = out_b.reshape(b, fg * per_class_k, 4)
    flat_s = out_s.reshape(b, fg * per_class_k)
    flat_c = torch.arange(1, fg + 1, device=rois.device).repeat_interleave(per_class_k)
    sel_s, sel_i = top_k(flat_s, d_out)
    valid = torch.isfinite(sel_s)
    return (
        torch.gather(flat_b, 1, sel_i[..., None].expand(b, d_out, 4)) * valid[..., None],
        torch.where(valid, sel_s, 0.0),
        torch.where(valid, flat_c[sel_i], 0).to(torch.int32),
        valid,
    )


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


# ---------------------------------------------------------------------------
# Mask branch (Mask R-CNN)


def crop_gt_masks(gt_masks, gt_boxes, gt_idx, rois, out_size: int) -> torch.Tensor:
    """Bilinear crop of each roi's matched gt mask to the mask head's grid.

    The gt masks are rasterized over their boxes (``data/loader.py``,
    the box's inclusive extent ``x2 - x1 + 1``); the centres of the roi's
    ``out_size`` x ``out_size`` grid map into that frame, and points
    outside the gt box are background (0).

    gt_masks (B, G, Hm, Wm), gt_boxes (B, G, 4), gt_idx (B, R), rois
    (B, R, 4) -> (B, R, out_size, out_size) float32 in [0, 1]."""
    hm, wm = gt_masks.shape[-2:]
    b, r = gt_idx.shape
    idx = gt_idx.long()
    masks = gt_masks[torch.arange(b, device=idx.device)[:, None], idx]   # (B, R, Hm, Wm)
    boxes = torch.gather(gt_boxes, 1, idx[..., None].expand(b, r, 4))
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0] + 1.0, min=1e-3)[..., None]
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1] + 1.0, min=1e-3)[..., None]
    grid = (torch.arange(out_size, dtype=torch.float32, device=rois.device) + 0.5) / out_size
    ys = rois[..., 1:2] + grid * (rois[..., 3:4] - rois[..., 1:2])          # (B, R, M)
    xs = rois[..., 0:1] + grid * (rois[..., 2:3] - rois[..., 0:1])
    v = (ys - boxes[..., 1:2]) / bh * hm - 0.5                               # mask pixel coords
    u = (xs - boxes[..., 0:1]) / bw * wm - 0.5
    inside = ((v > -1.0) & (v < hm))[..., :, None] & ((u > -1.0) & (u < wm))[..., None, :]
    v = torch.clamp(v, 0.0, hm - 1.0)
    u = torch.clamp(u, 0.0, wm - 1.0)
    v0, u0 = torch.floor(v).long(), torch.floor(u).long()
    lv, lu = v - v0, u - u0
    v1, u1 = torch.clamp(v0 + 1, max=hm - 1), torch.clamp(u0 + 1, max=wm - 1)

    def at(vi, ui):          # masks[b, r, vi[b, r, i], ui[b, r, j]] -> (B, R, M, M)
        rows = torch.gather(masks, 2, vi[..., None].expand(b, r, out_size, wm))
        return torch.gather(rows, 3, ui[..., None, :].expand(b, r, out_size, out_size))

    val = (
        at(v0, u0) * (1 - lv)[..., :, None] * (1 - lu)[..., None, :]
        + at(v0, u1) * (1 - lv)[..., :, None] * lu[..., None, :]
        + at(v1, u0) * lv[..., :, None] * (1 - lu)[..., None, :]
        + at(v1, u1) * lv[..., :, None] * lu[..., None, :]
    )
    return val * inside


def _mask_logits(model, feats, rois: torch.Tensor) -> torch.Tensor:
    """rois (B, R, 4) pooled at ``mask.pooled_size`` (ROIAlign, kernels B1
    and B2) through the mask head -> logits (B, R, M, M, C)."""
    cfg = model.cfg
    sm = cfg.mask.pooled_size
    pooled = _pool_rois_impl(cfg, feats, rois.contiguous(), sm, model.roi_levels)
    logits = model.mask(pooled.reshape(-1, sm, sm, pooled.shape[-1]))
    return logits.reshape(*rois.shape[:2], *logits.shape[1:])


def _own_class(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """logits (B, R, M, M, C), classes (B, R) -> each roi's own-class
    channel (B, R, M, M) in float32."""
    b, r = classes.shape
    bi = torch.arange(b, device=logits.device)[:, None]
    ri = torch.arange(r, device=logits.device)[None, :]
    return logits[bi, ri, :, :, classes.long()].float()


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy (optax's formulation)."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _mask_loss(mask_logits, samples: RoiSamples, gt_masks, gt_boxes, resolution: int):
    """Per-image binary CE on each fg roi's own-class mask channel,
    averaged over its pixels and over the image's fg rois.

    mask_logits (B, R, M, M, C) on the fg prefix of ``samples`` (R rows
    an image) -> (B,) float32."""
    targets = crop_gt_masks(gt_masks, gt_boxes, samples.gt_indices, samples.rois, resolution)
    per_roi = optax_sigmoid_ce(_own_class(mask_logits, samples.labels), targets).mean(dim=(2, 3))
    w = (samples.fg_mask & (samples.label_weights > 0)).to(torch.float32)
    return torch.sum(per_roi * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)


# ---------------------------------------------------------------------------
# Training


class Draws(NamedTuple):
    """The uniform priorities in [0, 1) of one train step: ``assign_fg``
    and ``assign_bg`` (B, A) for :func:`~mx_rcnn_tpu_torch.ops.sampling.
    assign_anchors`, ``sample_fg`` and ``sample_bg`` (B, R + G) for
    :func:`~mx_rcnn_tpu_torch.ops.sampling.sample_rois`, R the proposals
    an image (the RPN's or the batch's ``ext_rois``).  A generator draws
    them in this order in every mode: Fast R-CNN mode draws the two
    anchor fields and leaves them unused, so the sample draws do not
    depend on whether the RPN is in the graph (JAX splits its key into
    the assign and sample keys in every mode)."""

    assign_fg: torch.Tensor
    assign_bg: torch.Tensor
    sample_fg: torch.Tensor
    sample_bg: torch.Tensor


class BatchDraws:
    """The draws of one train step over ``rows`` images, handed out a
    microbatch at a time (gradient accumulation, ``parallel/step.py``).

    ``source`` is a :class:`Draws` of ``rows`` rows, or a generator from
    which each field is drawn for all ``rows`` images the first time a
    microbatch asks for it.  Microbatches ask in the order of
    :class:`Draws`'s fields, as :func:`forward_train` does, so the
    generator draws what the step over all ``rows`` images at once would
    draw, and microbatch ``j`` of ``B`` images (:meth:`micro`) takes rows
    ``jB .. jB + B - 1`` of every field: the same anchors and rois image
    for image as that step.  A field's row width (A anchors, or R + G with
    G the padded gt count) is fixed by the first microbatch that asks;
    the loader pads every batch to ``data.max_gt_boxes`` and
    ``num_proposals``, and a later microbatch of another width raises."""

    def __init__(self, source, rows: int) -> None:
        self.source, self.rows = source, rows
        self._drawn: dict[str, torch.Tensor] = {}

    def micro(self, j: int, b: int) -> "MicroDraws":
        """The draws of microbatch ``j`` of ``b`` images."""
        if (j + 1) * b > self.rows:
            raise ValueError(f"microbatch {j} of {b} images passes the {self.rows} rows drawn")
        return MicroDraws(self, j * b)

    def field(self, name: str, shape, device, lo: int) -> torch.Tensor:
        full = self._drawn.get(name)
        if full is None:
            full = _uniform(self.source, name, (self.rows, *shape[1:]), device)
            self._drawn[name] = full
        if tuple(full.shape[1:]) != tuple(shape[1:]):
            raise ValueError(f"draws.{name}: a microbatch asks for rows of {tuple(shape[1:])}, "
                             f"the step drew {tuple(full.shape[1:])}")
        return full[lo:lo + shape[0]]


class MicroDraws(NamedTuple):
    """Rows ``lo ..`` of a :class:`BatchDraws`."""

    whole: BatchDraws
    lo: int


def _uniform(draws, name: str, shape, device) -> torch.Tensor:
    """``draws.<name>`` when given, a microbatch's rows of a
    :class:`BatchDraws`, else a fresh (shape) draw from the generator
    ``draws``, in the fixed order the fields are asked for."""
    if isinstance(draws, Draws):
        return getattr(draws, name)
    if isinstance(draws, MicroDraws):
        return draws.whole.field(name, shape, device, draws.lo)
    return torch.rand(shape, generator=draws, device=device)


def _rpn_losses(rpn_logits, rpn_deltas, targets: AnchorTargets, loss_impl: str = "dense"):
    """RPN objectness (sigmoid BCE over the sampled anchors) and box
    (smooth-L1, sigma 3, fg anchors) losses, both normalized by the
    sampled count, and the objectness accuracy.  ``"dense"`` reduces over
    the full (B, A) anchor axis with masks, ``"compact"`` over the Q
    sampled rows; the same terms in another summation order."""
    if loss_impl == "compact":
        return _rpn_losses_compact(rpn_logits, rpn_deltas, targets)
    if loss_impl != "dense":
        raise ValueError(f"rpn.loss_impl must be 'dense' or 'compact', got {loss_impl!r}")
    rpn_logits = rpn_logits.to(torch.float32)
    rpn_deltas = rpn_deltas.to(torch.float32)
    valid = targets.valid_mask
    is_fg = targets.labels == 1
    n_valid = torch.clamp(valid.sum().to(torch.float32), min=1.0)
    fgf = is_fg.to(torch.float32)
    bce = -(fgf * F.logsigmoid(rpn_logits) + (1.0 - fgf) * F.logsigmoid(-rpn_logits))
    cls_loss = torch.sum(bce * valid) / n_valid
    box_loss = weighted_smooth_l1(
        rpn_deltas, targets.bbox_targets,
        inside_weight=targets.fg_mask[..., None].to(torch.float32),
        sigma=3.0, normalizer=n_valid,
    )
    acc = (((rpn_logits > 0.0) == is_fg) & valid).sum().to(torch.float32) / n_valid
    return cls_loss, box_loss, acc


def _rpn_losses_compact(rpn_logits, rpn_deltas, targets: AnchorTargets):
    idx = targets.sel_idx.long()                              # (B, Q)
    take = targets.sel_take.to(torch.float32)
    is_fg = targets.sel_fg
    n_valid = torch.clamp(take.sum(), min=1.0)
    logit_sel = torch.gather(rpn_logits, 1, idx).to(torch.float32)
    fgf = is_fg.to(torch.float32)
    bce = -(fgf * F.logsigmoid(logit_sel) + (1.0 - fgf) * F.logsigmoid(-logit_sel))
    cls_loss = torch.sum(bce * take) / n_valid
    idx4 = idx[..., None].expand(-1, -1, 4)
    deltas_sel = torch.gather(rpn_deltas, 1, idx4).to(torch.float32)
    targets_sel = torch.gather(targets.bbox_targets, 1, idx4)
    box_loss = weighted_smooth_l1(deltas_sel, targets_sel, inside_weight=fgf[..., None],
                                  sigma=3.0, normalizer=n_valid)
    acc = (((logit_sel > 0.0) == is_fg).to(torch.float32) * take).sum() / n_valid
    return cls_loss, box_loss, acc


def _rcnn_losses(cls_logits, box_deltas, samples: RoiSamples, class_agnostic: bool):
    """R-CNN softmax CE over the sampled rois and smooth-L1 (sigma 1) on
    the fg rois' deltas of their class, both normalized by the sampled
    count, and the classification accuracy.  cls_logits (N, C),
    box_deltas (N, C or 1, 4) over N = B * roi_batch_size."""
    cls_logits = cls_logits.to(torch.float32)
    box_deltas = box_deltas.to(torch.float32)
    labels = samples.labels.reshape(-1).long()
    weights = samples.label_weights.reshape(-1)
    fg = samples.fg_mask.reshape(-1)
    targets = samples.bbox_targets.reshape(-1, 4)
    n_valid = torch.clamp(weights.sum(), min=1.0)
    cls_loss = masked_softmax_cross_entropy(cls_logits, labels, weights)
    if class_agnostic:
        sel = box_deltas[:, 0, :]
    else:
        idx = torch.clamp(labels, 0, box_deltas.shape[1] - 1)
        sel = torch.gather(box_deltas, 1, idx[:, None, None].expand(-1, 1, 4))[:, 0, :]
    box_loss = weighted_smooth_l1(sel, targets, inside_weight=fg[:, None].to(torch.float32),
                                  sigma=1.0, normalizer=n_valid)
    pred = torch.argmax(cls_logits, dim=-1)
    acc = ((pred == labels).to(torch.float32) * weights).sum() / n_valid
    return cls_loss, box_loss, acc


def forward_train(model, batch: Batch, draws, pixel_stats=None):
    """One training forward pass -> (total loss, metrics dict).

    Differentiable with respect to the model's parameters.  ``draws`` is
    a :class:`Draws`, a microbatch's :class:`MicroDraws` or a
    ``torch.Generator`` on the batch's device (the four draws then come
    from it, in the order of :class:`Draws`'s fields).  Proposals and sampled rois are detached: gradients reach the
    RPN through its losses only.  ``pixel_stats``: (mean, std) for uint8
    batches.

    With ``batch.ext_rois`` the rois are sampled from those external
    proposals (and the gt).  Fast R-CNN mode, ``rpn.loss_weight`` 0: the
    RPN head never runs, its three metrics are exact zeros and its
    parameters get no gradient (``None``).  Joint mode, a positive
    weight: the RPN keeps its losses, only the sampling changes.

    With ``mask.enabled`` and ``batch.gt_masks``, the first
    ``roi_batch_size * fg_fraction`` sampled rois an image (the sampler
    puts every fg roi there) are pooled at ``mask.pooled_size`` and go
    through the mask head; their loss against the cropped gt masks,
    averaged over the batch, is ``MaskLogLoss`` and adds
    ``mask.loss_weight`` times itself to ``loss``."""
    cfg = model.cfg
    use_ext = _check_ext(batch)
    images = prep_images(batch.images, pixel_stats)
    feats = model.features(images)
    dev = images.device
    b = images.shape[0]
    anchors = level_anchors(cfg, feats)
    levels = sorted(feats)
    a = sum(anchors[l].shape[0] for l in levels)
    assign_fg = _uniform(draws, "assign_fg", (b, a), dev)
    assign_bg = _uniform(draws, "assign_bg", (b, a), dev)

    rpn = cfg.rpn
    if use_ext and rpn.loss_weight == 0.0:
        # Fast R-CNN mode (the reference's train_rcnn.py): no RPN head, no
        # anchor labelling, no RPN losses.
        rpn_cls = rpn_box = rpn_acc = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        rpn_out = model.rpn(feats)
        logits_cat = torch.cat([rpn_out[l][0] for l in levels], dim=1)
        deltas_cat = torch.cat([rpn_out[l][1] for l in levels], dim=1)
        anchors_cat = torch.cat([anchors[l] for l in levels], dim=0)
        with torch.no_grad():
            targets = assign_anchors(
                anchors_cat, batch.gt_boxes, batch.gt_valid, batch.image_hw, assign_fg, assign_bg,
                batch_size=rpn.batch_size, fg_fraction=rpn.fg_fraction,
                positive_iou=rpn.positive_iou, negative_iou=rpn.negative_iou,
                allowed_border=rpn.allowed_border, gt_ignore=batch.gt_ignore,
            )
        rpn_cls, rpn_box, rpn_acc = _rpn_losses(logits_cat, deltas_cat, targets, rpn.loss_impl)

    with torch.no_grad():
        if use_ext:
            rois, rois_valid = batch.ext_rois, batch.ext_valid
        else:
            scores = torch.sigmoid(logits_cat.detach())
            propose = _propose_one(cfg, train=True)
            rois, _, rois_valid = propose(
                *_slice_levels(levels, anchors, scores, deltas_cat.detach()), batch.image_hw)
        n = rois.shape[1] + batch.gt_boxes.shape[1]
        rc = cfg.rcnn
        samples = sample_rois(
            rois, rois_valid, batch.gt_boxes, batch.gt_classes, batch.gt_valid,
            _uniform(draws, "sample_fg", (b, n), dev), _uniform(draws, "sample_bg", (b, n), dev),
            batch_size=rc.roi_batch_size, fg_fraction=rc.fg_fraction, fg_iou=rc.fg_iou,
            bg_iou_hi=rc.bg_iou_hi, bg_iou_lo=rc.bg_iou_lo, bbox_weights=rc.bbox_weights,
            gt_ignore=batch.gt_ignore,
        )

    pooled = _pool_rois_impl(cfg, feats, samples.rois.contiguous(), rc.pooled_size,
                             model.roi_levels)
    s = rc.pooled_size
    cls_logits, box_deltas = model.box(pooled.reshape(-1, s, s, pooled.shape[-1]))
    rcnn_cls, rcnn_box, rcnn_acc = _rcnn_losses(cls_logits, box_deltas, samples,
                                                rc.class_agnostic)

    total = rpn.loss_weight * (rpn_cls + rpn_box) + rc.loss_weight * (rcnn_cls + rcnn_box)
    metrics = {
        "RPNAcc": rpn_acc,
        "RPNLogLoss": rpn_cls,
        "RPNL1Loss": rpn_box,
        "RCNNAcc": rcnn_acc,
        "RCNNLogLoss": rcnn_cls,
        "RCNNL1Loss": rcnn_box,
        "loss": total,
    }

    if cfg.mask.enabled and batch.gt_masks is not None:
        n_fg = max(int(rc.roi_batch_size * rc.fg_fraction), 1)
        fg = RoiSamples(*(x[:, :n_fg] for x in samples))
        mask_loss = torch.mean(_mask_loss(_mask_logits(model, feats, fg.rois), fg,
                                          batch.gt_masks, batch.gt_boxes, cfg.mask.resolution))
        total = total + cfg.mask.loss_weight * mask_loss
        metrics["MaskLogLoss"] = mask_loss
        metrics["loss"] = total
    return total, metrics
