"""Interchange / submission output formats (copy of
``mx_rcnn_tpu/evalutil/submission.py``).

The reference's ``evaluate_detections`` writes artifacts OTHER tools
consume, not just an in-memory metric:

- a COCO results json in ORIGINAL (sparse, 91-space) category ids — the
  format the COCO evaluation server and stock pycocotools ``loadRes``
  score (reference: ``rcnn/dataset/coco.py :: evaluate_detections`` →
  ``_write_coco_results`` per SURVEY.md §3.6);
- PASCAL VOC "comp4" per-class detection files — the devkit's official
  submission format (reference: ``rcnn/dataset/pascal_voc.py`` det-file
  writer, SURVEY.md §3.6).

This module converts between those wire formats and the framework's
internal per-image dict (``evalutil.detections``).  Both writers are the
exact inverses of the dataset readers' coordinate conventions
(``data/datasets.py``): COCO xywh ↔ internal inclusive xyxy via
``w = x2 - x1 + 1``; VOC 1-based pixel coords ↔ internal 0-based via
``+1``.  Round-trip tests (``tests/test_torch_submission.py``) hold write→read
to the internal evaluator's metrics.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np


def _coco_image_id(image_id: str):
    """COCO image ids are ints; the internal roidb stringifies them.
    Convert back only when the round-trip is lossless — ``int("000005")``
    is 5, and a gt json keyed by the zero-padded string would then never
    match a single result entry.  Non-numeric and non-canonical ids pass
    through as strings — stock pycocotools indexes results by whatever id
    type the gt json used."""
    try:
        as_int = int(image_id)
    except ValueError:
        return image_id
    return as_int if str(as_int) == image_id else image_id


def write_coco_results(
    path: str,
    per_image: Mapping[str, dict],
    label_to_cat: Optional[Mapping[int, int]] = None,
) -> int:
    """Write a COCO results json (detection + optional segmentation).

    ``label_to_cat`` maps the contiguous internal labels (1..80) back to
    the ORIGINAL sparse category ids (``CocoDataset.label_to_cat``); None
    is the identity (synthetic / custom datasets whose ids are already
    dense).  Boxes convert from internal inclusive xyxy to COCO
    ``[x, y, w, h]``.  Masks (when present) ride as uncompressed
    column-major RLE — ``{"size": [h, w], "counts": [ints]}`` — which
    stock pycocotools ``loadRes`` ingests via ``frUncompressedRLE``.

    Returns the number of result entries written.
    """
    results = []
    for image_id, d in per_image.items():
        iid = _coco_image_id(image_id)
        boxes = np.asarray(d["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(d["scores"], np.float64).reshape(-1)
        classes = np.asarray(d["classes"], np.int64).reshape(-1)
        masks = d.get("masks")
        for j in range(boxes.shape[0]):
            x1, y1, x2, y2 = boxes[j]
            cat = int(classes[j])
            if label_to_cat is not None:
                cat = int(label_to_cat[cat])
            entry = {
                "image_id": iid,
                "category_id": cat,
                "bbox": [
                    round(float(x1), 2),
                    round(float(y1), 2),
                    round(float(x2 - x1 + 1), 2),
                    round(float(y2 - y1 + 1), 2),
                ],
                "score": round(float(scores[j]), 5),
            }
            if masks is not None:
                m = masks[j]
                entry["segmentation"] = {
                    "size": [int(m["size"][0]), int(m["size"][1])],
                    "counts": np.asarray(m["counts"]).astype(int).tolist(),
                }
            results.append(entry)
    with open(path, "w") as f:
        json.dump(results, f)
    return len(results)


def read_coco_results(
    path: str,
    cat_to_label: Optional[Mapping[int, int]] = None,
) -> dict[str, dict]:
    """Inverse of :func:`write_coco_results`: results json → internal
    per-image dict (contiguous labels, inclusive xyxy), fit for
    ``evaluate_detections`` / ``save_detections``.  Used by the reeval
    path to score a submission file and by the round-trip tests."""
    with open(path) as f:
        results = json.load(f)
    grouped: dict[str, dict] = {}
    for r in results:
        g = grouped.setdefault(
            str(r["image_id"]),
            {"boxes": [], "scores": [], "classes": [], "masks": []},
        )
        x, y, w, h = r["bbox"]
        g["boxes"].append([x, y, x + w - 1, y + h - 1])
        g["scores"].append(r["score"])
        label = int(r["category_id"])
        if cat_to_label is not None:
            label = int(cat_to_label[label])
        g["classes"].append(label)
        if "segmentation" in r:
            seg = r["segmentation"]
            g["masks"].append(
                {
                    "size": tuple(seg["size"]),
                    "counts": np.asarray(seg["counts"], np.uint32),
                }
            )
    out = {}
    for k, g in grouped.items():
        if g["masks"] and len(g["masks"]) != len(g["boxes"]):
            # The internal "masks" list is positionally aligned with
            # boxes; a file where only SOME of an image's entries carry a
            # segmentation would silently pair masks with the wrong
            # detections downstream.  Reject rather than misalign.
            raise ValueError(
                f"image {k}: {len(g['masks'])} of {len(g['boxes'])} result "
                "entries carry a 'segmentation' — mixed box/segm entries "
                "within one image are not representable; score the file "
                "as box-only (strip segmentations) or complete them"
            )
        entry = {
            "boxes": np.asarray(g["boxes"], np.float32).reshape(-1, 4),
            "scores": np.asarray(g["scores"], np.float32),
            "classes": np.asarray(g["classes"], np.int32),
        }
        if g["masks"]:
            entry["masks"] = g["masks"]
        out[k] = entry
    return out


def write_voc_dets(
    out_dir: str,
    per_image: Mapping[str, dict],
    class_names: Sequence[str],
    imageset: str = "test",
    competition: str = "comp4",
) -> list[str]:
    """Write PASCAL VOC per-class detection files.

    One ``<competition>_det_<imageset>_<class>.txt`` per foreground
    class, each line ``image_id score x1 y1 x2 y2`` with 1-BASED pixel
    coordinates (the devkit convention; ``VocDataset._parse`` subtracts
    the same 1 on read).  Classes with zero detections still get an
    (empty) file — the devkit requires every class file to exist.

    Returns the written paths in class order.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for cls_idx, cls_name in enumerate(class_names):
        if cls_idx == 0:  # __background__
            continue
        path = os.path.join(
            out_dir, f"{competition}_det_{imageset}_{cls_name}.txt"
        )
        with open(path, "w") as f:
            for image_id, d in per_image.items():
                classes = np.asarray(d["classes"]).reshape(-1)
                sel = np.flatnonzero(classes == cls_idx)
                if sel.size == 0:
                    continue
                boxes = np.asarray(d["boxes"], np.float64).reshape(-1, 4)
                scores = np.asarray(d["scores"], np.float64).reshape(-1)
                for j in sel:
                    x1, y1, x2, y2 = boxes[j]
                    f.write(
                        f"{image_id} {scores[j]:.3f} {x1 + 1:.1f} "
                        f"{y1 + 1:.1f} {x2 + 1:.1f} {y2 + 1:.1f}\n"
                    )
        paths.append(path)
    return paths


def write_submission_artifacts(
    per_image: Mapping[str, dict],
    coco_results_path: Optional[str] = None,
    label_to_cat: Optional[Mapping[int, int]] = None,
    voc_dets_dir: Optional[str] = None,
    class_names: Sequence[str] = (),
    voc_imageset: str = "test",
) -> None:
    """The shared export block behind ``eval --dump-coco/--dump-voc`` and
    the reeval CLI's model-free re-export — one implementation so the two
    CLIs can't drift on format or naming."""
    import logging

    log = logging.getLogger("mx_rcnn_tpu_torch")
    if coco_results_path:
        n = write_coco_results(coco_results_path, per_image, label_to_cat)
        log.info("wrote %d COCO result entries to %s", n, coco_results_path)
    if voc_dets_dir:
        if len(class_names) <= 1:
            # write_voc_dets over an empty/background-only name tuple is a
            # silent no-op — the user asked for det files and must hear
            # why none appeared.
            raise ValueError(
                "--dump-voc needs foreground class names; the dataset "
                f"exposes {tuple(class_names)!r} — comp4 det files are "
                "per-class-NAME"
            )
        paths = write_voc_dets(
            voc_dets_dir, per_image, class_names, imageset=voc_imageset
        )
        log.info(
            "wrote %d comp4 det files to %s", len(paths), voc_dets_dir
        )


def read_voc_dets(
    out_dir: str,
    class_names: Sequence[str],
    imageset: str = "test",
    competition: str = "comp4",
) -> dict[str, dict]:
    """Inverse of :func:`write_voc_dets` (round-trip testing / scoring a
    foreign comp4 submission with the internal evaluator)."""
    grouped: dict[str, dict] = {}
    for cls_idx, cls_name in enumerate(class_names):
        if cls_idx == 0:
            continue
        path = os.path.join(
            out_dir, f"{competition}_det_{imageset}_{cls_name}.txt"
        )
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                image_id, score = parts[0], float(parts[1])
                x1, y1, x2, y2 = (float(v) - 1 for v in parts[2:6])
                g = grouped.setdefault(
                    image_id, {"boxes": [], "scores": [], "classes": []}
                )
                g["boxes"].append([x1, y1, x2, y2])
                g["scores"].append(score)
                g["classes"].append(cls_idx)
    return {
        k: {
            "boxes": np.asarray(g["boxes"], np.float32).reshape(-1, 4),
            "scores": np.asarray(g["scores"], np.float32),
            "classes": np.asarray(g["classes"], np.int32),
        }
        for k, g in grouped.items()
    }
