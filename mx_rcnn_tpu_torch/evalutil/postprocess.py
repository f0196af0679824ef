"""Detections back to the original image frame (copy of
``mx_rcnn_tpu/evalutil/postprocess.py``): drop invalid slots, undo the
letterbox scale, clip to the original extent, paste instance masks.
Masks are pasted from the UNCLIPPED boxes: the M x M grid spans the whole
box, so pasting it into a border-clipped extent would squash it;
``paste_mask`` crops at the canvas edge instead."""

from __future__ import annotations

from typing import Optional

import numpy as np

from mx_rcnn_tpu_torch.evalutil.masks import paste_mask, rle_encode


def unletterbox_detections(boxes, scores, classes, valid, scale: float,
                           height: int, width: int, masks: Optional[np.ndarray] = None,
                           mask_threshold: float = 0.0, encode_rle: bool = False) -> dict:
    """(D, 4) canvas boxes, (D,) scores/classes/valid ->
    {"boxes", "scores", "classes"} in original image coordinates, and with
    ``masks`` (D, M, M) probabilities a "masks" list, one entry a kept
    detection: its (height, width) bool mask, or with ``encode_rle`` its
    RLE.  Without ``encode_rle`` a detection scoring under
    ``mask_threshold`` gets None; with it every entry is kept, so the
    indexes stay aligned for evaluation."""
    valid = np.asarray(valid)
    raw = np.asarray(boxes)[valid] / scale
    clipped = raw.copy()
    clipped[:, [0, 2]] = clipped[:, [0, 2]].clip(0, width - 1)
    clipped[:, [1, 3]] = clipped[:, [1, 3]].clip(0, height - 1)
    out = {
        "boxes": clipped,
        "scores": np.asarray(scores)[valid],
        "classes": np.asarray(classes)[valid],
    }
    if masks is not None:
        pasted = []
        for m, b, s in zip(np.asarray(masks)[valid], raw, out["scores"]):
            if not encode_rle and s < mask_threshold:
                pasted.append(None)
                continue
            full = paste_mask(m, b, height, width)
            pasted.append(rle_encode(full) if encode_rle else full)
        out["masks"] = pasted
    return out


def _area(boxes: np.ndarray) -> np.ndarray:
    return np.prod(np.clip(boxes[..., 2:] - boxes[..., :2], 0, None), axis=-1)


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    union = _area(box) + _area(boxes) - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def match_fraction(ref: dict, out: dict, min_iou: float = 0.9,
                   score_tol: float = 1e-3) -> float:
    """Fraction of ``ref`` detections that ``out`` reproduces: one
    detection of the same class, IoU >= ``min_iou``, score within
    ``score_tol``, each ``out`` detection used once.  1.0 when ``ref`` is
    empty and ``out`` too."""
    n = len(ref["scores"])
    if n == 0:
        return 1.0 if len(out["scores"]) == 0 else 0.0
    used = np.zeros(len(out["scores"]), bool)
    hits = 0
    for box, score, cls in zip(ref["boxes"], ref["scores"], ref["classes"]):
        ok = (~used) & (out["classes"] == cls) & (np.abs(out["scores"] - score) <= score_tol)
        if ok.any():
            iou = np.where(ok, _iou_one_to_many(np.asarray(box), np.asarray(out["boxes"])), -1.0)
            j = int(np.argmax(iou))
            if iou[j] >= min_iou:
                used[j] = True
                hits += 1
    return hits / n
