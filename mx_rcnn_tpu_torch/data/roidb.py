"""The roidb record contract (copy of ``mx_rcnn_tpu/data/roidb.py``).

One record per image: its id, where its pixels come from (a file, or an
in-memory array for synthetic data), its true size, its gt boxes and
1-based classes in original image coordinates, and, for Mask R-CNN, each
box's segmentation as COCO keeps it (a list of polygons, or an RLE dict).  COCO crowd and VOC
difficult regions stay in the record as ``ignore`` flags: training keeps
them out of the negatives and evaluation ignore-matches them.  Readers put
non-ignore boxes first, so truncating the gt slots sheds ignore regions
before real objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class RoiRecord:
    image_id: str
    image_path: str            # "" for synthetic/in-memory images
    height: int
    width: int
    boxes: np.ndarray          # (n, 4) float32 x1 y1 x2 y2, unflipped coords
    gt_classes: np.ndarray     # (n,) int32, 1-based foreground labels
    flipped: bool = False
    # One segmentation a box, in image coordinates: a list of polygons
    # [x0, y0, x1, y1, ...] or a COCO RLE dict; None when the dataset has
    # none (data/loader.py rasterizes them box-relative).
    masks: Optional[list] = None
    # In-memory image for synthetic data: (H, W, 3) uint8.
    image_array: Optional[np.ndarray] = field(default=None, repr=False)
    # (n,) bool: COCO crowd / VOC difficult regions; None means all False.
    ignore: Optional[np.ndarray] = None

    @property
    def aspect(self) -> float:
        return self.width / max(self.height, 1)

    @property
    def ignore_flags(self) -> np.ndarray:
        """(n,) bool ignore mask, materialized (None -> all False)."""
        if self.ignore is None:
            return np.zeros(len(self.boxes), bool)
        return np.asarray(self.ignore, bool)


def filter_roidb(roidb: list[RoiRecord]) -> list[RoiRecord]:
    """Drop images without valid (non-ignore) gt boxes."""
    return [r for r in roidb if int((~r.ignore_flags).sum()) > 0]
