"""The evaluation loop: model -> detections -> dataset metric (port of
``mx_rcnn_tpu/evalutil/pred_eval.py``).

NMS and score thresholding happen in the graph (``forward_inference``);
here the detections go back to original image coordinates (the
reference's ``/ im_scale``), a Mask R-CNN's masks pasted and RLE-encoded,
and into the COCO (bbox, and ``segm/*`` when the detections carry masks)
or VOC evaluator.  Not ported: sharded and resumable evaluation,
visualisation and submission files.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.loader import record_scale
from mx_rcnn_tpu_torch.evalutil.coco_eval import CocoEvaluator
from mx_rcnn_tpu_torch.evalutil.detections import save_detections
from mx_rcnn_tpu_torch.evalutil.masks import gt_record_rles
from mx_rcnn_tpu_torch.evalutil.postprocess import unletterbox_detections
from mx_rcnn_tpu_torch.evalutil.voc_eval import voc_mean_ap


def collect_detections(eval_step: Callable, model, batches: Iterable, data_cfg: DataConfig,
                       progress: Optional[Callable[[int], None]] = None) -> dict[str, dict]:
    """Run ``eval_step(model, batch)`` over ``(batch, records)`` pairs
    (``data/loader.py::eval_batches``) -> image_id -> detections in
    original image coordinates.  A padded batch's extra rows are dropped:
    only its records are read back; a detection's mask, when the model
    has the mask branch, is pasted into its image and kept as an RLE."""
    out: dict[str, dict] = {}
    done = 0
    for batch, recs in batches:
        dets = eval_step(model, batch)
        n = len(recs)
        boxes, scores, classes, valid = (x[:n].cpu().numpy() for x in dets[:4])
        masks = dets.masks[:n].cpu().numpy() if dets.masks is not None else None
        for i, rec in enumerate(recs):
            out[rec.image_id] = unletterbox_detections(
                boxes[i], scores[i], classes[i], valid[i],
                record_scale(data_cfg, rec), rec.height, rec.width,
                masks=masks[i] if masks is not None else None, encode_rle=True,
            )
            done += 1
            if progress:
                progress(done)
    return out


def evaluate_detections(per_image: dict[str, dict], roidb, num_classes: int,
                        style: str = "coco", class_names: Optional[tuple] = None,
                        use_07_metric: bool = False) -> dict[str, float]:
    """Score detections against the roidb's gt (callable on loaded
    detections with no model).  COCO style: when any image's detections
    carry masks, the segm metric too, its numbers as ``segm/<name>``,
    against the records' gt masks (``evalutil/masks.py::gt_record_rles``);
    an image entry without masks scores its gt as misses."""
    if style == "coco":
        ev = CocoEvaluator(num_classes)
        have_masks = any("masks" in d for d in per_image.values())
        seg_ev = CocoEvaluator(num_classes, iou_type="segm") if have_masks else None
        for rec in roidb:
            d = per_image.get(
                rec.image_id,
                {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "classes": np.zeros(0)},
            )
            ev.add_image(rec.image_id, d["boxes"], d["scores"], d["classes"],
                         rec.boxes, rec.gt_classes, gt_crowd=rec.ignore_flags)
            if seg_ev is not None:
                has_m, z = "masks" in d, np.zeros(0)
                seg_ev.add_image(
                    rec.image_id,
                    d["boxes"] if has_m else np.zeros((0, 4)),
                    d["scores"] if has_m else z,
                    d["classes"] if has_m else z,
                    rec.boxes, rec.gt_classes,
                    det_masks=d.get("masks", []), gt_masks=gt_record_rles(rec),
                    gt_crowd=rec.ignore_flags,
                )
        metrics = ev.summarize()
        if seg_ev is not None:
            metrics.update({f"segm/{k}": v for k, v in seg_ev.summarize().items()})
        return metrics
    if style == "voc":
        all_dets: dict[int, dict] = {c: {} for c in range(1, num_classes)}
        all_gt: dict[int, dict] = {c: {} for c in range(1, num_classes)}
        for rec in roidb:
            d = per_image.get(rec.image_id)
            for c in range(1, num_classes):
                if d is not None:
                    m = d["classes"] == c
                    if m.any():
                        all_dets[c][rec.image_id] = np.concatenate(
                            [d["boxes"][m], d["scores"][m, None]], axis=1)
                gm = rec.gt_classes == c
                if gm.any():
                    # Difficult objects stay in the gt with their flag:
                    # matched to one, a detection is neither tp nor fp.
                    all_gt[c][rec.image_id] = {"boxes": rec.boxes[gm],
                                               "difficult": rec.ignore_flags[gm]}
        names = class_names or tuple(str(i) for i in range(num_classes))
        return voc_mean_ap(all_dets, all_gt, names, use_07_metric=use_07_metric)
    raise ValueError(f"unknown eval style {style!r}")


def pred_eval(eval_step: Callable, model, batches: Iterable, roidb, data_cfg: DataConfig,
              num_classes: int, style: str = "coco", class_names: Optional[tuple] = None,
              use_07_metric: bool = False, dump_path: Optional[str] = None,
              progress: Optional[Callable[[int], None]] = None) -> dict[str, float]:
    """Detections over ``batches``, optionally dumped to ``dump_path``
    (``save_detections`` format), scored against ``roidb``; ``progress``
    gets the count of images done after each one."""
    per_image = collect_detections(eval_step, model, batches, data_cfg, progress)
    if dump_path:
        save_detections(dump_path, per_image)
    return evaluate_detections(per_image, roidb, num_classes, style, class_names,
                               use_07_metric)
