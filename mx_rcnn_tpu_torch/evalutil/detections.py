"""Detection result caching (dump / load / re-eval); copy of
``mx_rcnn_tpu/evalutil/detections.py``.

Replaces the reference's ``all_boxes`` pickle written by ``pred_eval`` and
re-scored by ``rcnn/tools/reeval.py``.  Format: one JSON-serializable dict
per image — stable across refactors, unlike the reference's positional
per-class nested lists.
"""

from __future__ import annotations

import json

import numpy as np


def save_detections(path: str, per_image: dict[str, dict]) -> None:
    """per_image: image_id → {"boxes": (n,4), "scores": (n,), "classes": (n,)}
    plus optional "masks": list of RLE dicts (instance segmentation)."""
    ser = {}
    for k, v in per_image.items():
        entry = {
            "boxes": np.asarray(v["boxes"], float).reshape(-1, 4).tolist(),
            "scores": np.asarray(v["scores"], float).reshape(-1).tolist(),
            "classes": np.asarray(v["classes"], int).reshape(-1).tolist(),
        }
        if "masks" in v:
            entry["masks"] = [
                {"size": list(m["size"]), "counts": np.asarray(m["counts"]).tolist()}
                for m in v["masks"]
            ]
        ser[k] = entry
    with open(path, "w") as f:
        json.dump(ser, f)


def detections_from_json(raw: dict) -> dict[str, dict]:
    """Raw parsed-JSON dump (``save_detections`` format) → numpy arrays.

    Factored out of :func:`load_detections` so sharded evaluation can merge
    shard dumps at the raw-JSON level (byte-stable — the float32 round-trip
    here is lossy) and still hand arrays to the evaluator."""
    out = {}
    for k, v in raw.items():
        entry = {
            "boxes": np.asarray(v["boxes"], np.float32).reshape(-1, 4),
            "scores": np.asarray(v["scores"], np.float32).reshape(-1),
            "classes": np.asarray(v["classes"], np.int32).reshape(-1),
        }
        if "masks" in v:
            entry["masks"] = [
                {"size": tuple(m["size"]), "counts": np.asarray(m["counts"], np.uint32)}
                for m in v["masks"]
            ]
        out[k] = entry
    return out


def load_detections(path: str) -> dict[str, dict]:
    with open(path) as f:
        raw = json.load(f)
    return detections_from_json(raw)
