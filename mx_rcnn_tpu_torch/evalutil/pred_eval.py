"""The evaluation loop: model -> detections -> dataset metric (port of
``mx_rcnn_tpu/evalutil/pred_eval.py``).

NMS and score thresholding happen in the graph (``forward_inference``);
here the detections go back to original image coordinates (the
reference's ``/ im_scale``), a Mask R-CNN's masks pasted and RLE-encoded,
and into the COCO (bbox, and ``segm/*`` when the detections carry masks)
or VOC evaluator.  Around that: the preemption-safe sharded pass
(:func:`collect_detections_sharded`, its shard files and merged dump byte
for byte the JAX package's), the submission files
(``evalutil/submission.py``) and the drawn images
(:func:`visualize_detections`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from typing import TYPE_CHECKING, Callable, Iterable, Optional

import numpy as np

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.evalutil.coco_eval import CocoEvaluator
from mx_rcnn_tpu_torch.evalutil.detections import detections_from_json, save_detections
from mx_rcnn_tpu_torch.evalutil.masks import gt_record_rles, rle_decode
from mx_rcnn_tpu_torch.evalutil.postprocess import unletterbox_detections
from mx_rcnn_tpu_torch.evalutil.voc_eval import voc_mean_ap

if TYPE_CHECKING:
    from mx_rcnn_tpu_torch.data.loader import DetectionLoader

log = logging.getLogger("mx_rcnn_tpu_torch")


def batch_detections(eval_step: Callable, model, batch, recs, data_cfg: DataConfig
                     ) -> dict[str, dict]:
    """``eval_step(model, batch)`` -> image_id -> detections in original
    image coordinates for the batch's ``recs`` (a padded batch's extra
    rows are dropped); a detection's mask, when the model has the mask
    branch, is pasted into its image and kept as an RLE."""
    # data.loader imports evalutil.masks: imported here, not at the top.
    from mx_rcnn_tpu_torch.data.loader import record_scale

    dets = eval_step(model, batch)
    n = len(recs)
    boxes, scores, classes, valid = (x[:n].cpu().numpy() for x in dets[:4])
    masks = dets.masks[:n].cpu().numpy() if dets.masks is not None else None
    return {rec.image_id: unletterbox_detections(
                boxes[i], scores[i], classes[i], valid[i], record_scale(data_cfg, rec),
                rec.height, rec.width, masks=masks[i] if masks is not None else None,
                encode_rle=True)
            for i, rec in enumerate(recs)}


def collect_detections(eval_step: Callable, model, batches: Iterable, data_cfg: DataConfig,
                       progress: Optional[Callable[[int], None]] = None) -> dict[str, dict]:
    """:func:`batch_detections` over ``(batch, records)`` pairs (the eval
    loader's) -> image_id -> detections; ``progress`` gets the count of
    images done after each one."""
    out: dict[str, dict] = {}
    for batch, recs in batches:
        for image_id, d in batch_detections(eval_step, model, batch, recs, data_cfg).items():
            out[image_id] = d
            if progress:
                progress(len(out))
    return out


MANIFEST_NAME = "manifest.json"


def shard_path(shard_dir: str, idx: int) -> str:
    return os.path.join(shard_dir, f"shard-{idx:05d}.json")


def eval_schedule_fingerprint(loader: DetectionLoader, shard_size: int) -> str:
    """SHA-1 of everything that decides which images land in which shard
    (the JAX package's bytes, so either package's shards are recognised):
    a resumed run may only reuse shard files written under the same
    schedule, or some images would be scored twice and others never."""
    h = hashlib.sha1()
    h.update(f"bs={loader.batch_size};shard={shard_size}".encode())
    for _, recs in loader.eval_specs():
        for r in recs:
            h.update(str(r.image_id).encode())
            h.update(b"\x00")
        h.update(b"\x01")
    return h.hexdigest()


def _write_json_atomic(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def collect_detections_sharded(eval_step: Callable, model, loader: DetectionLoader,
                               shard_dir: str, shard_size: int = 8, resume: bool = False,
                               max_retries: int = 1, guard=None,
                               progress: Optional[Callable[[int], None]] = None) -> list[str]:
    """Preemption-safe :func:`collect_detections`: the eval schedule
    (``loader.eval_specs()``) is cut into shards of ``shard_size``
    batches; each finished shard is written atomically (a temporary file,
    then ``os.replace``: a shard file that exists is complete) under
    ``shard_dir`` in ``save_detections`` format, beside a manifest with
    the schedule's fingerprint.

    ``resume=False`` starts clean (stale shard files are deleted);
    ``resume=True`` refuses a manifest of another schedule and skips the
    shards on disk.  A shard that raises is retried up to ``max_retries``
    times, then the error propagates.  ``guard`` (a
    ``train/preemption.py::PreemptionGuard``) is polled after each shard:
    the shard in flight when the signal landed is finished and written,
    then ``Preempted(shard, shard_dir)`` is raised.  ``progress`` gets the
    count of images done after each shard.  Returns the shard files in
    order."""
    from mx_rcnn_tpu_torch.train.preemption import Preempted

    if shard_size < 1:
        raise ValueError("shard_size must be >= 1")
    specs = loader.eval_specs()
    num_batches = len(specs)
    num_shards = max(1, -(-num_batches // shard_size))
    fingerprint = eval_schedule_fingerprint(loader, shard_size)
    os.makedirs(shard_dir, exist_ok=True)
    manifest_path = os.path.join(shard_dir, MANIFEST_NAME)
    manifest = {"fingerprint": fingerprint, "batch_size": loader.batch_size,
                "shard_size": shard_size, "num_batches": num_batches, "num_shards": num_shards}
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            prev = json.load(f)
        if prev.get("fingerprint") != fingerprint:
            raise ValueError(f"--resume refused: {shard_dir} was written under a different eval "
                             "schedule (dataset/batch-size/shard-size changed); start fresh "
                             "without --resume")
    else:
        # A fresh start: shard files of an older schedule must neither merge
        # into this run nor be skipped by it.
        for name in os.listdir(shard_dir):
            if name.startswith("shard-") and name.endswith(".json"):
                os.remove(os.path.join(shard_dir, name))
        _write_json_atomic(manifest_path, manifest)

    done_images = 0
    paths = []
    for s in range(num_shards):
        path = shard_path(shard_dir, s)
        paths.append(path)
        start, stop = s * shard_size, min((s + 1) * shard_size, num_batches)
        n_images = sum(len(recs) for _, recs in specs[start:stop])
        if resume and os.path.exists(path):
            done_images += n_images
            if progress:
                progress(done_images)
            continue
        for attempt in range(max_retries + 1):
            try:
                shard_out: dict[str, dict] = {}
                for batch, recs in loader.eval_batch_range(start, stop):
                    shard_out.update(batch_detections(eval_step, model, batch, recs, loader.cfg))
                save_detections(path + ".tmp", shard_out)
                os.replace(path + ".tmp", path)
                break
            except Exception:
                if attempt >= max_retries:
                    raise
                log.warning("eval shard %d/%d failed (attempt %d/%d); retrying", s, num_shards,
                            attempt + 1, max_retries + 1, exc_info=True)
        done_images += n_images
        if progress:
            progress(done_images)
        if guard is not None and guard.triggered:
            # The shard in flight when the signal landed is on disk.
            raise Preempted(s, shard_dir)
    return paths


def merge_detection_shards(shard_paths: list[str], out_path: Optional[str] = None) -> dict:
    """Shard dumps merged into one detections dict at the raw JSON level
    (and written to ``out_path``): ``save_detections`` writes float64 text
    that a float32 parse and re-save would change, so merging the parsed
    JSON keeps an interrupted and resumed run's dump byte for byte an
    uninterrupted run's.  Returns the merged raw dict."""
    merged: dict = {}
    for p in shard_paths:
        with open(p) as f:
            merged.update(json.load(f))
    if out_path:
        _write_json_atomic(out_path, merged)
    return merged


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


def visualize_detections(per_image: dict[str, dict], roidb, out_dir: str,
                         class_names: Optional[tuple] = None, count: int = 10,
                         threshold: float = 0.5) -> int:
    """Draw the first ``count`` evaluated images of ``roidb`` with their
    detections (and masks) into ``out_dir`` (the reference's
    ``pred_eval(vis=True)``, written to files); returns the images
    written.  Needs matplotlib (``evalutil/vis.py``)."""
    from mx_rcnn_tpu_torch.data.loader import load_image
    from mx_rcnn_tpu_torch.evalutil.vis import draw_detections

    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for rec in roidb:
        if written >= count:
            break
        d = per_image.get(rec.image_id)
        if d is None:
            continue
        masks = None
        if "masks" in d:
            masks = [rle_decode(m).astype(bool) if isinstance(m, dict) else m
                     for m in d["masks"]]
        name = re.sub(r"[^A-Za-z0-9_.-]", "_", str(rec.image_id))
        draw_detections(load_image(rec), d["boxes"], d["scores"], d["classes"], class_names,
                        os.path.join(out_dir, f"{name}.png"), threshold=threshold, masks=masks)
        written += 1
    return written


def pred_eval(eval_step: Callable, model, batches: Iterable, roidb, data_cfg: DataConfig,
              num_classes: int, style: str = "coco", class_names: Optional[tuple] = None,
              use_07_metric: bool = False, dump_path: Optional[str] = None,
              progress: Optional[Callable[[int], None]] = None,
              vis_dir: Optional[str] = None, vis_count: int = 10,
              coco_results_path: Optional[str] = None, label_to_cat=None,
              voc_dets_dir: Optional[str] = None, voc_imageset: str = "test",
              shard_dir: Optional[str] = None, shard_size: int = 8, resume: bool = False,
              shard_retries: int = 1, guard=None) -> dict[str, float]:
    """Detections over ``batches`` (the eval loader, or any iterable of
    ``(batch, records)`` pairs), optionally dumped to ``dump_path``
    (``save_detections`` format), scored against ``roidb``; ``progress``
    gets the count of images done.

    ``shard_dir``: the preemption-safe sharded pass over the eval loader
    ``batches`` (:func:`collect_detections_sharded`, with ``shard_size``,
    ``resume``, ``shard_retries`` and ``guard``); the dump is merged from
    the shard files at the raw JSON level and the metrics come from that
    dump's parse, so an interrupted and resumed run scores the same bytes
    as an uninterrupted one.  ``coco_results_path`` / ``voc_dets_dir``
    also write the submission files (a COCO results json in the original
    category ids through ``label_to_cat``; VOC comp4 det files named by
    ``class_names`` and ``voc_imageset``).  ``vis_dir``: the first
    ``vis_count`` images drawn there (:func:`visualize_detections`)."""
    if shard_dir:
        paths = collect_detections_sharded(eval_step, model, batches, shard_dir,
                                           shard_size=shard_size, resume=resume,
                                           max_retries=shard_retries, guard=guard,
                                           progress=progress)
        per_image = detections_from_json(merge_detection_shards(paths, out_path=dump_path))
    else:
        per_image = collect_detections(eval_step, model, batches, data_cfg, progress)
        if dump_path:
            save_detections(dump_path, per_image)
    if coco_results_path or voc_dets_dir:
        from mx_rcnn_tpu_torch.evalutil.submission import write_submission_artifacts

        write_submission_artifacts(per_image, coco_results_path=coco_results_path,
                                   label_to_cat=label_to_cat, voc_dets_dir=voc_dets_dir,
                                   class_names=class_names or (), voc_imageset=voc_imageset)
    if vis_dir:
        n = visualize_detections(per_image, roidb, vis_dir, class_names, count=vis_count)
        log.info("wrote %d visualization(s) to %s", n, vis_dir)
    return evaluate_detections(per_image, roidb, num_classes, style, class_names,
                               use_07_metric)
