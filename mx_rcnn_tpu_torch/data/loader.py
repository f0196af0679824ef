"""Minimal train batch assembly (the per-image path of
``mx_rcnn_tpu/data/loader.py::DetectionLoader._assemble``).

Each record is letterboxed as uint8 into the landscape canvas
``data.image_size`` by the loader's scale rule (short side to
``short_side`` unless the long side passes ``max_side``, clamped to the
canvas), its boxes scaled by the same factor, and its gt padded to
``data.max_gt_boxes`` with ``gt_valid``.  Pixels stay uint8; the graph
normalizes them (``detection/graph.py::prep_images``).  The resize is
``data/transforms.py``'s torch bilinear, rounded back to uint8; an image
already at its letterbox size is not resampled.

Not ported: flips, aspect grouping (portrait canvases), shuffling,
prefetch and the input service.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from mx_rcnn_tpu_torch.config import DataConfig
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.datasets import Record
from mx_rcnn_tpu_torch.data.transforms import resize_linear, resize_scale


def record_scale(cfg: DataConfig, height: int, width: int) -> float:
    """The letterbox scale of a (height, width) image in the canvas."""
    ch, cw = cfg.image_size
    return min(resize_scale(height, width, cfg.short_side, cfg.max_side),
               ch / height, cw / width)


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


def assemble(records: Sequence[Record], cfg: DataConfig, device) -> Batch:
    """One train batch on ``device`` from uint8 records."""
    g = cfg.max_gt_boxes
    images, hws, boxes, classes, valid = [], [], [], [], []
    for rec in records:
        if rec.image.dtype != np.uint8:
            raise ValueError(f"record {rec.image_id!r}: the loader takes uint8 images, "
                             f"got {rec.image.dtype}")
        scale = record_scale(cfg, rec.height, rec.width)
        nh, nw = int(round(rec.height * scale)), int(round(rec.width * scale))
        images.append(letterbox_uint8(torch.from_numpy(rec.image).to(device),
                                      cfg.image_size, nh, nw))
        hws.append([nh, nw])
        n = min(len(rec.boxes), g)
        gb = np.zeros((g, 4), np.float32)
        gc = np.zeros((g,), np.int32)
        gv = np.zeros((g,), bool)
        gb[:n] = rec.boxes[:n].astype(np.float32) * scale
        gc[:n] = rec.gt_classes[:n]
        gv[:n] = True
        boxes.append(gb)
        classes.append(gc)
        valid.append(gv)
    return Batch(
        images=torch.stack(images),
        image_hw=torch.tensor(np.asarray(hws, np.float32), device=device),
        gt_boxes=torch.tensor(np.stack(boxes), device=device),
        gt_classes=torch.tensor(np.stack(classes), device=device),
        gt_valid=torch.tensor(np.stack(valid), device=device),
    )


def batches(dataset, batch_size: int, cfg: DataConfig, device) -> Iterator[Batch]:
    """Batches of consecutive records, cycling through the dataset."""
    i = 0
    while True:
        recs = [dataset.record((i + k) % len(dataset)) for k in range(batch_size)]
        i += batch_size
        yield assemble(recs, cfg, device)
