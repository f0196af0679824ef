"""PASCAL VOC detection AP (copy of ``mx_rcnn_tpu/evalutil/voc_eval.py``).

Port of the metric in ``rcnn/dataset/pascal_voc_eval.py::voc_eval`` (itself
the standard Girshick eval): greedy score-ordered matching at IoU≥0.5,
difficult gts ignored, both the 11-point (``use_07_metric``) and the
every-point (area-under-PR) AP.  Input is in-memory detections instead of
the reference's comp4 det files — file round-trips add nothing here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


@dataclass
class _ClassGt:
    boxes: np.ndarray
    difficult: np.ndarray
    matched: np.ndarray = field(init=False)

    def __post_init__(self):
        self.matched = np.zeros(len(self.boxes), bool)


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    iw = np.maximum(ix2 - ix1 + 1.0, 0.0)
    ih = np.maximum(iy2 - iy1 + 1.0, 0.0)
    inter = iw * ih
    a = (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
    b = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    return inter / np.maximum(a + b - inter, 1e-10)


def voc_eval(
    detections: dict[str, np.ndarray],
    gt: dict[str, dict],
    iou_threshold: float = 0.5,
    use_07_metric: bool = False,
) -> tuple[float, np.ndarray, np.ndarray]:
    """AP for one class.

    detections: image_id → (n, 5) [x1 y1 x2 y2 score].
    gt: image_id → {"boxes": (m, 4), "difficult": (m,) bool}.
    Returns (ap, recall_curve, precision_curve).
    """
    gts = {
        k: _ClassGt(np.asarray(v["boxes"], float).reshape(-1, 4),
                    np.asarray(v.get("difficult", np.zeros(len(v["boxes"]), bool)), bool))
        for k, v in gt.items()
    }
    npos = sum(int((~g.difficult).sum()) for g in gts.values())

    rows = []
    for img_id, dets in detections.items():
        for d in np.asarray(dets, float).reshape(-1, 5):
            rows.append((float(d[4]), img_id, d[:4]))
    if not rows or npos == 0:
        return 0.0, np.zeros(0), np.zeros(0)
    rows.sort(key=lambda r: -r[0])

    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for i, (_, img_id, box) in enumerate(rows):
        g = gts.get(img_id)
        if g is None or len(g.boxes) == 0:
            fp[i] = 1
            continue
        ious = _iou_one_to_many(box, g.boxes)
        j = int(np.argmax(ious))
        if ious[j] >= iou_threshold:
            if g.difficult[j]:
                continue  # ignored, neither tp nor fp
            if not g.matched[j]:
                tp[i] = 1
                g.matched[j] = True
            else:
                fp[i] = 1  # duplicate detection
        else:
            fp[i] = 1

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    rec = tp_cum / npos
    prec = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric), rec, prec


def voc_mean_ap(
    all_detections: dict[int, dict[str, np.ndarray]],
    all_gt: dict[int, dict[str, dict]],
    class_names: tuple[str, ...],
    iou_threshold: float = 0.5,
    use_07_metric: bool = False,
) -> dict[str, float]:
    """Per-class AP + mAP.  Keys of the outer dicts are class labels
    (1-based foreground)."""
    aps = {}
    for c, dets in all_detections.items():
        ap, _, _ = voc_eval(dets, all_gt.get(c, {}), iou_threshold, use_07_metric)
        aps[class_names[c]] = ap
    aps["mAP"] = float(np.mean([v for k, v in aps.items() if k != "mAP"])) if aps else 0.0
    return aps
