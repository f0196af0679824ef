"""Detections back to the original image frame (copy of
``mx_rcnn_tpu/evalutil/postprocess.py`` without masks): drop invalid
slots, undo the letterbox scale, clip to the original extent."""

from __future__ import annotations

import numpy as np


def unletterbox_detections(boxes, scores, classes, valid, scale: float,
                           height: int, width: int) -> dict:
    """(D, 4) canvas boxes, (D,) scores/classes/valid ->
    {"boxes", "scores", "classes"} in original image coordinates."""
    valid = np.asarray(valid)
    clipped = np.asarray(boxes)[valid] / scale
    clipped[:, [0, 2]] = clipped[:, [0, 2]].clip(0, width - 1)
    clipped[:, [1, 3]] = clipped[:, [1, 3]].clip(0, height - 1)
    return {
        "boxes": clipped,
        "scores": np.asarray(scores)[valid],
        "classes": np.asarray(classes)[valid],
    }


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
