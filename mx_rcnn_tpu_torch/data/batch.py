"""The Batch contract between the input side and the detection graph
(copy of ``mx_rcnn_tpu/data/batch.py``).  Fields are torch tensors on the
device the graph runs on; serving fills only ``images`` and ``image_hw``.
``ext_rois``/``ext_valid`` carry external proposals (Fast R-CNN mode:
``detection/graph.py`` samples or scores them in place of the RPN's);
``gt_masks`` the gt instance masks of Mask R-CNN training.  The fields
are those of the JAX batch, ``gt_masks`` last (the JAX batch holds it
after ``gt_valid``)."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional


class Batch(NamedTuple):
    # (B, H, W, 3): uint8 raw letterboxed pixels (normalized in-graph by
    # detection/graph.py::prep_images) or float32 already normalized.
    images: Any
    image_hw: Any     # (B, 2) float32 true (unpadded) height, width
    gt_boxes: Optional[Any] = None    # (B, G, 4)
    gt_classes: Optional[Any] = None  # (B, G) int32, 0 = background/padding
    gt_valid: Optional[Any] = None    # (B, G) bool
    # COCO crowd / VOC difficult regions: never fg, and anchors/rois covering
    # them are excluded from bg sampling.  Disjoint from gt_valid slots.
    gt_ignore: Optional[Any] = None   # (B, G) bool
    # External proposals in letterboxed-image coordinates, score-descending,
    # zero-padded (the reference's ROIIter / train_rcnn path).  None = the
    # RPN's in-graph proposals.
    ext_rois: Optional[Any] = None    # (B, R, 4) float32
    ext_valid: Optional[Any] = None   # (B, R) bool
    # Each gt slot's instance mask rasterized over its box
    # (data/loader.py::GT_MASK_SIZE square), zero for ignore and padding
    # slots; None without Mask R-CNN.
    gt_masks: Optional[Any] = None    # (B, G, Hm, Wm) float32 in [0, 1]
