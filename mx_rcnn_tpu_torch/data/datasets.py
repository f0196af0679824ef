"""The synthetic dataset (port of ``mx_rcnn_tpu/data/datasets.py::
SyntheticDataset``, boxes and classes only).

Deterministic images with filled, class-textured rectangles on a noise
background, rendered in numpy exactly as the JAX package renders them
with ``dtype="uint8"`` (its "classic" palette), so both packages see the
same pixels and boxes for the same (seed, index).  Pixels are uint8, the
one form the loader takes (the graph normalizes them).  Records render
on access.  The "wheel" palette, float32 pixels and the COCO and VOC
readers are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Record(NamedTuple):
    image_id: str
    height: int
    width: int
    boxes: np.ndarray       # (N, 4) float32, inclusive-corner pixel boxes
    gt_classes: np.ndarray  # (N,) int32, 1-based
    image: np.ndarray       # (H, W, 3) uint8


class SyntheticDataset:
    name = "synthetic"

    def __init__(self, num_images: int = 64, image_hw: tuple[int, int] = (128, 128),
                 num_classes: int = 5, max_objects: int = 4, seed: int = 0) -> None:
        self.num_images = num_images
        self.image_hw = image_hw
        self.num_classes = num_classes  # incl. background 0
        self.max_objects = max_objects
        self.seed = seed

    def __len__(self) -> int:
        return self.num_images

    def record(self, idx: int) -> Record:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.image_hw
        img = rng.uniform(0, 40, size=(h, w, 3)).astype(np.float32)
        n = rng.randint(1, self.max_objects + 1)
        boxes, classes = [], []
        for _ in range(n):
            cls = rng.randint(1, self.num_classes)
            bw = rng.randint(h // 8, h // 2)
            bh = rng.randint(h // 8, h // 2)
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            # Class-specific color and stripes whose period encodes the class.
            yy, xx = np.mgrid[y1 : y1 + bh, x1 : x1 + bw]
            stripe = ((xx // (cls + 1) + yy // (cls + 1)) % 2).astype(np.float32)
            color = np.array([80 + 40 * cls, 255 - 35 * cls, 120 + 25 * (cls % 3)], np.float32)
            img[y1 : y1 + bh, x1 : x1 + bw] = color * (0.6 + 0.4 * stripe[..., None])
            boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
            classes.append(cls)
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
        return Record(str(idx), h, w, np.asarray(boxes, np.float32),
                      np.asarray(classes, np.int32), img)
