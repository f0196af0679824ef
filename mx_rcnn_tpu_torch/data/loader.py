"""Batch assembly (the per-image path of
``mx_rcnn_tpu/data/loader.py::DetectionLoader``).

Each record is letterboxed as uint8 into its oriented canvas (the
landscape ``data.image_size``, transposed for portrait records) by the
loader's scale rule (short side to ``short_side`` unless the long side
passes ``max_side``, clamped to the canvas), its boxes scaled by the same
factor, and its gt padded to ``data.max_gt_boxes`` with ``gt_valid`` (and
``gt_ignore`` where a record has crowd or difficult regions).  Pixels stay
uint8; the graph normalizes them (``detection/graph.py::prep_images``).
The resize is ``data/transforms.py``'s torch bilinear, rounded back to
uint8; an image already at its letterbox size is not resampled.

Training cycles through the records in order (:func:`batches`); eval runs
one pass in the JAX loader's schedule (:func:`eval_index_specs`).  Not
ported: flips, aspect grouping of training batches, shuffling, prefetch,
quarantine and the input service.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.data.transforms import oriented_canvas, resize_linear, resize_scale


def load_image(rec: RoiRecord) -> np.ndarray:
    """The record's (H, W, 3) uint8 RGB pixels: its in-memory array, or its
    file decoded with PIL."""
    if rec.image_array is not None:
        return rec.image_array
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"record {rec.image_id!r}: decoding {rec.image_path} needs PIL, "
                           "which is not installed") from e
    with Image.open(rec.image_path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def record_canvas(cfg: DataConfig, rec: RoiRecord) -> tuple[int, int]:
    """The static canvas the record letterboxes into."""
    return oriented_canvas(cfg.image_size, rec.height, rec.width)


def record_scale(cfg: DataConfig, rec: RoiRecord) -> float:
    """The letterbox scale of the record in its canvas (the reference's
    ``im_scale``, undone on the detections at eval)."""
    ch, cw = record_canvas(cfg, rec)
    return min(resize_scale(rec.height, rec.width, cfg.short_side, cfg.max_side),
               ch / rec.height, cw / rec.width)


def letterbox_uint8(image: torch.Tensor, canvas_hw: tuple[int, int], nh: int,
                    nw: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> resized to (nh, nw), pasted top-left into a
    zero uint8 canvas."""
    canvas = torch.zeros((*canvas_hw, 3), dtype=torch.uint8, device=image.device)
    if image.shape[:2] == (nh, nw):
        canvas[:nh, :nw] = image
    else:
        resized = resize_linear(image, nh, nw)
        canvas[:nh, :nw] = torch.clamp(torch.round(resized), 0, 255).to(torch.uint8)
    return canvas


def assemble(records: Sequence[RoiRecord], cfg: DataConfig, device) -> Batch:
    """One batch on ``device`` from uint8 records of one orientation."""
    canvases = {record_canvas(cfg, rec) for rec in records}
    if len(canvases) > 1:
        raise ValueError(f"records of two orientations in one batch (canvases "
                         f"{sorted(canvases)}); batch portrait and landscape records apart")
    g = cfg.max_gt_boxes
    images, hws, boxes, classes, valid, ignore = [], [], [], [], [], []
    for rec in records:
        pixels = load_image(rec)
        if pixels.dtype != np.uint8:
            raise ValueError(f"record {rec.image_id!r}: the loader takes uint8 images, "
                             f"got {pixels.dtype}")
        scale = record_scale(cfg, rec)
        nh, nw = int(round(rec.height * scale)), int(round(rec.width * scale))
        images.append(letterbox_uint8(torch.from_numpy(pixels).to(device),
                                      record_canvas(cfg, rec), nh, nw))
        hws.append([nh, nw])
        n = min(len(rec.boxes), g)
        ign = rec.ignore_flags
        gb = np.zeros((g, 4), np.float32)
        gc = np.zeros((g,), np.int32)
        gv = np.zeros((g,), bool)
        gi = np.zeros((g,), bool)
        gb[:n] = rec.boxes[:n].astype(np.float32) * scale
        gc[:n] = rec.gt_classes[:n]
        gv[:n] = ~ign[:n]
        gi[:n] = ign[:n]
        boxes.append(gb)
        classes.append(gc)
        valid.append(gv)
        ignore.append(gi)
    return Batch(
        images=torch.stack(images),
        image_hw=torch.tensor(np.asarray(hws, np.float32), device=device),
        gt_boxes=torch.tensor(np.stack(boxes), device=device),
        gt_classes=torch.tensor(np.stack(classes), device=device),
        gt_valid=torch.tensor(np.stack(valid), device=device),
        gt_ignore=(torch.tensor(np.stack(ignore), device=device)
                   if any(r.ignore_flags.any() for r in records) else None),
    )


def batches(dataset, batch_size: int, cfg: DataConfig, device) -> Iterator[Batch]:
    """Train batches of consecutive records, cycling through the dataset."""
    i = 0
    while True:
        recs = [dataset.record((i + k) % len(dataset)) for k in range(batch_size)]
        i += batch_size
        yield assemble(recs, cfg, device)


def eval_index_specs(roidb: Sequence[RoiRecord], cfg: DataConfig,
                     batch_size: int) -> list[tuple[list[int], list[int]]]:
    """The eval schedule: one ``(rows, records)`` pair of roidb indices a
    batch.  On a non-square canvas landscape records come first, then
    portrait, each in roidb order, so every batch has one canvas.  A short
    last batch of a group is padded with its last record: ``rows`` is the
    padded batch, ``records`` the real ones, which alone are scored."""
    idx_all = list(range(len(roidb)))
    ch, cw = cfg.image_size
    if ch == cw:
        groups = [idx_all]
    else:
        groups = [[j for j in idx_all if roidb[j].aspect >= 1],
                  [j for j in idx_all if roidb[j].aspect < 1]]
    specs = []
    for group in groups:
        for i in range(0, len(group), batch_size):
            idxs = group[i:i + batch_size]
            specs.append((idxs + [idxs[-1]] * (batch_size - len(idxs)), idxs))
    return specs


def eval_batches(roidb: Sequence[RoiRecord], cfg: DataConfig, batch_size: int,
                 device) -> Iterator[tuple[Batch, list[RoiRecord]]]:
    """One pass over ``roidb`` in :func:`eval_index_specs` order:
    ``(batch, records)``, the batch padded to ``batch_size``."""
    for rows, idxs in eval_index_specs(roidb, cfg, batch_size):
        yield assemble([roidb[j] for j in rows], cfg, device), [roidb[j] for j in idxs]
