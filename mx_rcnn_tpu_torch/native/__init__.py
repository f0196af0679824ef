"""The native (C++) host library (port of ``mx_rcnn_tpu/native``).

Greedy NMS, the COCO RLE encode and mask IoU, and a fused uint8
letterbox-and-normalize, in ``src/native.cc`` behind a ctypes interface
(``lib.py``).  The library is built with g++ at first use
(``build.py``); every entry point has a numpy version of the same bits,
which serves where the library cannot be built.  ``evalutil/masks.py``
encodes and scores masks through it when it is built.
"""

from mx_rcnn_tpu_torch.native.lib import (
    available,
    cpu_nms,
    letterbox_normalize,
    rle_encode_native,
    rle_iou_native,
)

__all__ = [
    "available",
    "cpu_nms",
    "letterbox_normalize",
    "rle_encode_native",
    "rle_iou_native",
]
