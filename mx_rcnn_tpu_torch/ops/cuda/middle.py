"""The fused proposal middle: CUDA kernel B3 and its plain version.

Replaces ``mx_rcnn_tpu/ops/pallas/middle.py::fused_middle_levels``, the
kernel behind ``rpn.fused_middle`` (``serve.fused_middle="on"``).  Over
per-(image, level) top-k candidates it decodes (weights 1,
``BBOX_XFORM_CLIP``), clips, snaps to 1/256 px, masks boxes below
``min_size`` and runs greedy NMS in positional order, IoU snapped to
2**-16.  The kernel (``csrc/middle.cu``) is bitwise equal to its plain
version, ``decode_candidates`` + ``nms_mask`` over the same candidates,
because the candidates arrive in top-k order (scores descending, ties by
ascending index), where the stable argsort inside ``nms_mask`` is the
identity on the valid lanes.

:func:`fused_middle_levels` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.  ``fused_middle_levels.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mx_rcnn_tpu_torch.ops.cuda import _build
from mx_rcnn_tpu_torch.ops.nms import nms_mask
from mx_rcnn_tpu_torch.ops.proposals import decode_candidates

# Shared memory bounds the candidates a block holds: 21 B each, 227 KB.
MAX_CANDIDATES = 227 * 1024 // 21


def fused_middle_levels_plain(anchors, deltas, scores, image_hw, min_size=0.0,
                              iou_threshold=0.7):
    """What the kernel computes, in plain torch: (boxes, masked scores,
    keep) from candidates (B, L, k, ...) of B images."""
    boxes, masked = decode_candidates(scores, deltas, anchors, image_hw, min_size)
    return boxes, masked, nms_mask(boxes, masked, iou_threshold)


def _launch(anchors, deltas, scores, image_hw, min_size, iou_threshold):
    b, lv, k = scores.shape
    for name, t, shape in (
        ("anchors", anchors, (b, lv, k, 4)),
        ("deltas", deltas, (b, lv, k, 4)),
        ("scores", scores, (b, lv, k)),
        ("image_hw", image_hw, (b, 2)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused middle: {name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused middle: {name} must be float32, got {t.dtype}")
        if t.device != scores.device:
            raise ValueError(f"fused middle: {name} on {t.device}, scores on {scores.device}")
    if k > MAX_CANDIDATES:
        raise ValueError(f"fused middle: k={k} exceeds {MAX_CANDIDATES} candidates a block")
    anchors, deltas, scores, image_hw = (
        t.contiguous() for t in (anchors, deltas, scores, image_hw)
    )
    dev = scores.device
    boxes = torch.empty((b, lv, k, 4), dtype=torch.float32, device=dev)
    masked = torch.empty((b, lv, k), dtype=torch.float32, device=dev)
    keep = torch.empty((b, lv, k), dtype=torch.uint8, device=dev)
    fn = _build.entry("middle", "fused_middle_levels", [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    rc = fn(anchors.data_ptr(), deltas.data_ptr(), scores.data_ptr(), image_hw.data_ptr(),
            boxes.data_ptr(), masked.data_ptr(), keep.data_ptr(), b, lv, k,
            float(min_size), float(iou_threshold), _build.stream_ptr(dev))
    _build.check("middle", rc, "fused_middle_levels")
    fused_middle_levels.launches += 1
    return boxes, masked, keep.bool()


def fused_middle_levels(anchors, deltas, scores, image_hw, min_size=0.0, iou_threshold=0.7):
    """anchors, deltas (B, L, k, 4) f32 gathered in top-k order (zero rows
    past a level's true k); scores (B, L, k) f32, ``-inf`` on pad lanes;
    image_hw (B, 2) f32 -> (boxes (B, L, k, 4), masked scores (B, L, k),
    keep (B, L, k) bool)."""
    if scores.device.type == "cpu":
        return fused_middle_levels_plain(anchors, deltas, scores, image_hw, min_size,
                                         iou_threshold)
    if scores.device.type != "cuda":
        raise ValueError(f"fused middle: unsupported device {scores.device}")
    return _launch(anchors, deltas, scores, image_hw, min_size, iou_threshold)


fused_middle_levels.launches = 0
