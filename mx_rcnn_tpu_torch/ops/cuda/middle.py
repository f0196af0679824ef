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

The kernel runs in two launches: the 64-bit suppression words of the
upper-triangle 64x64 tiles (decode included), then the chunked greedy
sweep that B4 shares.  Their plain versions are
:func:`suppression_words_plain` and :func:`chunked_sweep_plain`.

:func:`fused_middle_levels` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.  ``fused_middle_levels.launches``
counts wrapper calls (two kernel launches each).
"""

from __future__ import annotations

import ctypes

import torch

from mx_rcnn_tpu_torch.geometry import iou_matrix, snap
from mx_rcnn_tpu_torch.ops.cuda import _build
from mx_rcnn_tpu_torch.ops.nms import nms_mask
from mx_rcnn_tpu_torch.ops.proposals import decode_candidates

TILE = 64  # rows a suppression word covers (csrc/nms_sweep.cuh kTile)
# The sweep stages two 64-row chunks of words and the removed bitset in
# shared memory, 8 * (1 + 2 * 64) bytes a word column, 227 KB a block:
# whole chunks up to 225 word columns (csrc/nms_sweep.cuh max_rows).
MAX_CANDIDATES = TILE * (227 * 1024 // (8 * (1 + 2 * TILE)))


def fused_middle_levels_plain(anchors, deltas, scores, image_hw, min_size=0.0,
                              iou_threshold=0.7):
    """What the kernel computes, in plain torch: (boxes, masked scores,
    keep) from candidates (B, L, k, ...) of B images."""
    boxes, masked = decode_candidates(scores, deltas, anchors, image_hw, min_size)
    return boxes, masked, nms_mask(boxes, masked, iou_threshold)


def suppression_words_plain(boxes, valid, iou_threshold):
    """Launch (a)'s words in plain torch: boxes (..., k, 4) in positional
    order, valid (..., k) -> (..., k, ceil(k/64)) int64, bit c of word w of
    row i set when i < j = 64 w + c, both valid, and the snapped IoU (areas
    clamped) exceeds the threshold.  Words below the diagonal are 0."""
    k = boxes.shape[-2]
    cb = -(-k // TILE)
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    sup = ((snap(iou_matrix(boxes, boxes)) > iou_threshold) & upper
           & valid[..., :, None] & valid[..., None, :])
    sup = torch.nn.functional.pad(sup, (0, cb * TILE - k)).reshape(*sup.shape[:-1], cb, TILE)
    words = torch.zeros(sup.shape[:-1], dtype=torch.int64, device=boxes.device)
    for c in range(TILE):
        words |= sup[..., c].long() << c
    return words


def chunked_sweep_plain(words, valid):
    """Launch (b) in plain torch, chunk by chunk as the kernel sweeps:
    words (..., k, cb) int64 from :func:`suppression_words_plain`, valid
    (..., k) -> keep (..., k) bool.  ``removed`` starts as ~valid; in each
    64-row chunk the diagonal word is resolved row by row, then the kept
    rows' later words are ORed into ``removed``."""
    k, cb = words.shape[-2:]
    lead = words.shape[:-2]
    bit = torch.ones((), dtype=torch.int64, device=words.device)
    pad = torch.nn.functional.pad(valid, (0, cb * TILE - k)).reshape(*lead, cb, TILE)
    removed = torch.zeros((*lead, cb), dtype=torch.int64, device=words.device)
    for c in range(TILE):
        removed |= (~pad[..., c]).long() << c
    keep = torch.zeros((*lead, k), dtype=torch.bool, device=words.device)
    for w in range(cb):
        alive = ~removed[..., w]
        rows = range(w * TILE, min(k, (w + 1) * TILE))
        for r, i in enumerate(rows):
            live = (alive >> r) & bit
            alive = alive & ~(words[..., i, w] * live)
        for r, i in enumerate(rows):
            kept = ((alive >> r) & bit).bool()
            keep[..., i] = kept
            removed[..., w + 1:] |= torch.where(kept[..., None], words[..., i, w + 1:], 0)
    return keep


def _check(anchors, deltas, scores, image_hw):
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
        raise ValueError(f"fused middle: k={k} exceeds the sweep's {MAX_CANDIDATES} candidates")


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_float,
                                                          ctypes.c_void_p]


def _launch(anchors, deltas, scores, image_hw, min_size, iou_threshold):
    _check(anchors, deltas, scores, image_hw)
    b, lv, k = scores.shape
    anchors, deltas, scores, image_hw = (
        t.contiguous() for t in (anchors, deltas, scores, image_hw)
    )
    dev = scores.device
    words = torch.empty((b, lv, k, -(-k // TILE)), dtype=torch.int64, device=dev)
    boxes = torch.empty((b, lv, k, 4), dtype=torch.float32, device=dev)
    masked = torch.empty((b, lv, k), dtype=torch.float32, device=dev)
    keep = torch.empty((b, lv, k), dtype=torch.bool, device=dev)
    fn = _build.entry("middle", "fused_middle_levels", _ARGTYPES)
    rc = fn(anchors.data_ptr(), deltas.data_ptr(), scores.data_ptr(), image_hw.data_ptr(),
            words.data_ptr(), boxes.data_ptr(), masked.data_ptr(), keep.data_ptr(), b, lv, k,
            float(min_size), float(iou_threshold), _build.stream_ptr(dev))
    _build.check("middle", rc, "fused_middle_levels")
    fused_middle_levels.launches += 1
    return boxes, masked, keep, words


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
    return _launch(anchors, deltas, scores, image_hw, min_size, iou_threshold)[:3]


fused_middle_levels.launches = 0
