"""Self-contained COCO-style detection evaluator (numpy; copy of
``mx_rcnn_tpu/evalutil/coco_eval.py``): the bbox metric, and with
``iou_type="segm"`` the segm metric on RLE masks.

Re-implements the COCO bbox metric from its public definition — the
reference reaches it through vendored pycocotools
(``rcnn/pycocotools/cocoeval.py``; not installed in this image): per
(category, IoU∈0.5:0.05:0.95, area range, maxDets) greedy score-ordered
matching, 101-point interpolated AP, and the standard 12-number summary
(AP, AP50, AP75, APs/m/l, AR1/10/100, ARs/m/l).

Crowd-ignore matching follows pycocotools: crowd gts never count toward
recall, detections overlapping them (intersection-over-det-area, the
``iou(..., iscrowd=1)`` measure) match as *ignored* — neither TP nor FP —
and an already-matched crowd gt can absorb further detections.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from mx_rcnn_tpu_torch.evalutil.masks import rle_area, rle_iou

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _xyxy_iou(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """(n, 4) x (m, 4) → (n, m) IoU (continuous coords, no +1: COCO
    convention, unlike the VOC evaluator's integer-pixel +1)."""
    ix1 = np.maximum(d[:, None, 0], g[None, :, 0])
    iy1 = np.maximum(d[:, None, 1], g[None, :, 1])
    ix2 = np.minimum(d[:, None, 2], g[None, :, 2])
    iy2 = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    ad = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    ag = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    return inter / np.maximum(ad[:, None] + ag[None, :] - inter, 1e-10)


def _greedy_match_batched(
    ious: np.ndarray, g_ignore: np.ndarray, g_crowd: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The pycocotools matching rule, vectorized, batched
    over A independent problems sharing the det list — the evaluator folds
    the four area buckets (whose gt columns are permutations of one IoU
    matrix) into one call.

    The det loop is inherently sequential (each det consumes a gt), but per
    det the A×T×G search collapses to array ops: among available real gts
    pick the last index attaining the max IoU (the oracle's ``>=`` update
    makes later ties win); only if none clears the threshold may an
    available ignored gt match (the oracle's break rule — reaching the
    ignored block with a real candidate stops the scan: the JAX package's
    ``_greedy_match_reference`` triple loop is the oracle).  Dets whose max
    IoU over every problem's gts misses the lowest threshold can never
    match anywhere and are skipped.

    Args: ious (A, D, G); g_ignore, g_crowd (A, G).
    Returns: (dt_match (A, T, D), gt_match (A, T, G)).
    """
    A, D, G = ious.shape
    T = len(IOU_THRS)
    dt_match = np.zeros((A, T, D), dtype=np.int64)
    gt_match = np.zeros((A, T, G), dtype=np.int64)
    if D == 0 or G == 0:
        return dt_match, gt_match
    thr = np.minimum(IOU_THRS, 1 - 1e-10)[None, :]  # (1, T)
    real = ~g_ignore[:, None, :]                    # (A, 1, G)
    ign = g_ignore[:, None, :]
    crowd_avail = (g_ignore & g_crowd)[:, None, :]  # crowd: matched-but-available
    aidx = np.arange(A)[:, None]
    tidx = np.arange(T)[None, :]
    active = np.flatnonzero(ious.max(axis=2).max(axis=0) >= thr.min())
    for d in active:
        iou_d = ious[:, d, None, :]                             # (A, 1, G)
        free = gt_match == 0                                    # (A, T, G)
        cand = np.where(real & free, iou_d, -1.0)
        j_real = G - 1 - np.argmax(cand[:, :, ::-1], axis=2)    # last argmax
        ok_real = cand[aidx, tidx, j_real] >= thr               # (A, T)
        cand = np.where(crowd_avail | (ign & free), iou_d, -1.0)
        j_ign = G - 1 - np.argmax(cand[:, :, ::-1], axis=2)
        ok_ign = ~ok_real & (cand[aidx, tidx, j_ign] >= thr)
        j = np.where(ok_real, j_real, np.where(ok_ign, j_ign, -1))
        hit = j >= 0
        dt_match[hit, d] = j[hit] + 1
        a_hit, t_hit = np.nonzero(hit)
        gt_match[a_hit, t_hit, j[hit]] = d + 1
    return dt_match, gt_match


def _greedy_match(
    ious: np.ndarray, g_ignore: np.ndarray, g_crowd: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Single-problem wrapper over :func:`_greedy_match_batched`."""
    dt, gtm = _greedy_match_batched(
        ious[None], np.asarray(g_ignore, bool)[None], np.asarray(g_crowd, bool)[None]
    )
    return dt[0], gtm[0]


class CocoEvaluator:
    """Accumulate per-image detections + gt, then summarize.

    add_image() per image; summarize() → the 12 COCO numbers plus
    per-category AP.  Labels are contiguous 1-based category indices.
    """

    def __init__(self, num_classes: int, iou_type: str = "bbox") -> None:
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type must be bbox|segm, got {iou_type!r}")
        self.iou_type = iou_type
        self.num_classes = num_classes  # incl. background 0
        # (cat, image) → dict(dt=..., gt=..., iou=...)
        self._dts: dict = defaultdict(list)
        self._gts: dict = defaultdict(list)
        # cat → insertion-ordered image ids with dets or gt of that class
        # (dict as ordered set: deterministic accumulation order).
        self._cat_images: dict = defaultdict(dict)

    def add_image(
        self,
        image_id,
        det_boxes: np.ndarray,    # (n, 4) xyxy in ORIGINAL image coords
        det_scores: np.ndarray,   # (n,)
        det_classes: np.ndarray,  # (n,) 1-based
        gt_boxes: np.ndarray,     # (m, 4)
        gt_classes: np.ndarray,   # (m,)
        det_masks: list | None = None,  # n RLE dicts (segm mode)
        gt_masks: list | None = None,   # m RLE dicts (segm mode)
        gt_crowd: np.ndarray | None = None,  # (m,) bool iscrowd flags
    ) -> None:
        det_boxes = np.asarray(det_boxes, float).reshape(-1, 4)
        gt_boxes = np.asarray(gt_boxes, float).reshape(-1, 4)
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_boxes), bool)
        gt_crowd = np.asarray(gt_crowd, bool).reshape(len(gt_boxes))
        if self.iou_type == "segm" and (det_masks is None or gt_masks is None):
            raise ValueError("segm evaluation needs det_masks and gt_masks RLEs")
        for c in range(1, self.num_classes):
            dm = np.flatnonzero(np.asarray(det_classes) == c)
            gm = np.flatnonzero(np.asarray(gt_classes) == c)
            if dm.size:
                self._dts[(c, image_id)] = (
                    det_boxes[dm],
                    np.asarray(det_scores, float)[dm],
                    [det_masks[i] for i in dm] if det_masks is not None else None,
                )
            if gm.size:
                self._gts[(c, image_id)] = (
                    gt_boxes[gm],
                    [gt_masks[i] for i in gm] if gt_masks is not None else None,
                    gt_crowd[gm],
                )
            if dm.size or gm.size:
                self._cat_images[c][image_id] = None

    # -- matching ----------------------------------------------------------

    def _cached_ious(self, cat: int, img, cache: dict):
        """(ious, dscores, darea, garea, g_crowd) for a (cat, img) pair:
        dets score-sorted and capped at MAX_DETS[-1], gts in stored order,
        crowd columns already converted to intersection-over-det-area.
        Area-range filtering only permutes/ignores gt columns, so one cache
        entry serves all four area buckets (pycocotools computes its ious
        once the same way).
        """
        key = (cat, img)
        if key in cache:
            return cache[key]
        dt = self._dts.get(key)
        gt = self._gts.get(key)
        if dt is None:
            dboxes, dscores, dmasks = np.zeros((0, 4)), np.zeros(0), []
        else:
            dboxes, dscores, dmasks = dt
            order = np.argsort(-dscores, kind="mergesort")[: MAX_DETS[-1]]
            dboxes, dscores = dboxes[order], dscores[order]
            dmasks = [dmasks[i] for i in order] if dmasks is not None else []
        gboxes, gmasks, g_crowd = (
            gt if gt is not None else (np.zeros((0, 4)), [], np.zeros(0, bool))
        )
        if self.iou_type == "segm":
            garea = np.asarray([rle_area(m) for m in (gmasks or [])], float).reshape(len(gboxes))
            darea = np.asarray([rle_area(m) for m in dmasks], float).reshape(len(dboxes))
            ious = rle_iou(dmasks, gmasks or [])
        else:
            garea = (gboxes[:, 2] - gboxes[:, 0]) * (gboxes[:, 3] - gboxes[:, 1])
            darea = (dboxes[:, 2] - dboxes[:, 0]) * (dboxes[:, 3] - dboxes[:, 1])
            ious = _xyxy_iou(dboxes, gboxes)
        if g_crowd.any() and len(dboxes):
            # Crowd overlap is intersection-over-det-area (pycocotools
            # iou(..., iscrowd=1)): recover the intersection from the IoU
            # and the two areas, renormalize by det area alone.
            inter = ious * (darea[:, None] + garea[None, :]) / (1.0 + ious)
            ioa = inter / np.maximum(darea[:, None], 1e-10)
            ious = np.where(g_crowd[None, :], ioa, ious)
        entry = (ious, dscores, darea, garea, g_crowd)
        cache[key] = entry
        return entry

    def _evaluate_img(self, cat: int, img, cache: dict):
        """→ {area: per-image match record}, one batched matcher call.

        Matches at maxDet=MAX_DETS[-1]; smaller maxDets are prefix slices
        of the returned arrays (greedy matching in score order is
        prefix-consistent — det k's match never depends on det k+1).  The
        four area buckets share one IoU matrix (area filtering only flips
        ignore flags and permutes gt columns), so they run as one batched
        problem."""
        if (cat, img) not in self._dts and (cat, img) not in self._gts:
            return None
        ious, dscores, darea, garea, g_crowd = self._cached_ious(cat, img, cache)
        areas = list(AREA_RANGES.items())
        ious_a, ign_a, crowd_a = [], [], []
        for _, rng in areas:
            # Crowd gts are ignored regardless of area; area filtering
            # ignores the rest outside the range (pycocotools _ignore).
            g_ignore = g_crowd | (garea < rng[0]) | (garea > rng[1])
            # Sort gt: non-ignored first (COCO matches real gt first).
            g_order = np.argsort(g_ignore, kind="mergesort")
            ious_a.append(ious[:, g_order])
            ign_a.append(g_ignore[g_order])
            crowd_a.append(g_crowd[g_order])
        ign_a = np.stack(ign_a)
        dt_match_a, _ = _greedy_match_batched(
            np.stack(ious_a), ign_a, np.stack(crowd_a)
        )
        out = {}
        for ai, (name, rng) in enumerate(areas):
            dt_match, g_ignore = dt_match_a[ai], ign_a[ai]
            # Unmatched dets outside the area range are ignored, matched-
            # to-ignored-gt dets are ignored.
            matched = dt_match > 0
            matched_ignore = np.zeros_like(matched)
            if g_ignore.size:
                matched_ignore[matched] = g_ignore[dt_match[matched] - 1]
            d_out = (darea < rng[0]) | (darea > rng[1])
            out[name] = {
                "scores": dscores,
                "dt_match": dt_match,
                "dt_ignore": np.where(matched, matched_ignore, d_out[None, :]),
                "num_gt": int((~g_ignore).sum()),
            }
        return out

    @staticmethod
    def _accumulate(per_img: list, max_det: int):
        """→ (precision (T, R), recall (T,)) or None if no gt anywhere."""
        if not per_img:
            return None
        npos = sum(r["num_gt"] for r in per_img)
        if npos == 0:
            return None
        scores = np.concatenate([r["scores"][:max_det] for r in per_img])
        order = np.argsort(-scores, kind="mergesort")
        T = len(IOU_THRS)
        matches = np.concatenate(
            [r["dt_match"][:, :max_det] for r in per_img], axis=1
        )[:, order]
        ignores = np.concatenate(
            [r["dt_ignore"][:, :max_det] for r in per_img], axis=1
        )[:, order]

        keep = ~ignores
        tps = np.cumsum((matches > 0) & keep, axis=1)  # (T, D)
        fps = np.cumsum((matches == 0) & keep, axis=1)
        rc = tps / npos
        pr = tps / np.maximum(tps + fps, 1e-10)
        precision = np.zeros((T, len(RECALL_THRS)))
        recall = rc[:, -1] if rc.shape[1] else np.zeros(T)
        # Monotone non-increasing precision envelope.
        pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
        for ti in range(T):
            idx = np.searchsorted(rc[ti], RECALL_THRS, side="left")
            valid = idx < pr.shape[1]
            precision[ti, valid] = pr[ti, idx[valid]]
        return precision, recall

    # -- summary -----------------------------------------------------------

    def summarize(self) -> dict[str, float]:
        cats = range(1, self.num_classes)
        iou_cache: dict = {}
        acc: dict = {}
        for c in cats:
            by_area: dict[str, list] = {a: [] for a in AREA_RANGES}
            for img in self._cat_images.get(c, ()):
                r = self._evaluate_img(c, img, iou_cache)
                if r:
                    for a, rec in r.items():
                        by_area[a].append(rec)
            for a in AREA_RANGES:
                # COCO only varies one of area / maxDet at a time.
                for m in MAX_DETS if a == "all" else (MAX_DETS[-1],):
                    acc[(c, a, m)] = self._accumulate(by_area[a], m)

        def mean_ap(area: str, max_det: int, iou_idx=None) -> float:
            vals = []
            for c in cats:
                r = acc.get((c, area, max_det))
                if r is None:
                    continue
                p = r[0] if iou_idx is None else r[0][iou_idx : iou_idx + 1]
                vals.append(np.mean(p))
            return float(np.mean(vals)) if vals else -1.0

        def mean_ar(area: str, max_det: int) -> float:
            vals = [
                np.mean(r[1])
                for c in cats
                if (r := acc.get((c, area, max_det))) is not None
            ]
            return float(np.mean(vals)) if vals else -1.0

        out = {
            "AP": mean_ap("all", 100),
            "AP50": mean_ap("all", 100, iou_idx=0),
            "AP75": mean_ap("all", 100, iou_idx=5),
            "APs": mean_ap("small", 100),
            "APm": mean_ap("medium", 100),
            "APl": mean_ap("large", 100),
            "AR1": mean_ar("all", 1),
            "AR10": mean_ar("all", 10),
            "AR100": mean_ar("all", 100),
            "ARs": mean_ar("small", 100),
            "ARm": mean_ar("medium", 100),
            "ARl": mean_ar("large", 100),
        }
        for c in cats:
            r = acc.get((c, "all", 100))
            if r is not None:
                out[f"AP/class_{c}"] = float(np.mean(r[0]))
        return out
