"""Box geometry in torch (port of ``mx_rcnn_tpu/geometry/boxes.py``).

Boxes are ``(x1, y1, x2, y2)`` corners with the modern width convention
(``x2 - x1``, no ``+ 1``).  Every function is written operation for
operation like the JAX version so that, on the same float32 inputs, the
snapped outputs are bitwise equal: ``torch.round`` rounds half to even like
``jnp.round``, and each elementwise op rounds once (no contraction).
"""

from __future__ import annotations

import torch

# Bound on dw/dh before exp() (np.log(1000 / 16)).
BBOX_XFORM_CLIP = 4.135166556742356

# IoU/score snap grid, 2**-16.
SNAP_BITS = 16


def snap(x: torch.Tensor, bits: int = SNAP_BITS) -> torch.Tensor:
    """Round onto the exact ``2**-bits`` grid, half to even.  The scale,
    the round and the scale back are each exact in float32, so discrete
    consumers (thresholds, top-k, NMS) decide the same way on every
    backend.  Infinities pass through."""
    scale = 2.0 ** bits
    return torch.round(x * scale) * (1.0 / scale)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas with negative extents clamped to zero. boxes: (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.clamp(w, min=0.0) * torch.clamp(h, min=0.0)


def iou_matrix(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: boxes (..., N, 4), query (..., K, 4) -> (..., N, K).
    Zero-union pairs are 0."""
    lt = torch.maximum(boxes[..., :, None, :2], query[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], query[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = area(boxes)[..., :, None]
    a2 = area(query)[..., None, :]
    union = a1 + a2 - inter
    pos = union > 0.0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def ioa_matrix(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection over the area of ``boxes`` (the crowd/ignore
    overlap measure): boxes (..., N, 4), query (..., K, 4) -> (..., N, K).
    Zero-area ``boxes`` rows are 0."""
    lt = torch.maximum(boxes[..., :, None, :2], query[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], query[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a = area(boxes)[..., :, None]
    pos = a > 0.0
    return torch.where(pos, inter / torch.where(pos, a, 1.0), 0.0)


def _center(boxes: torch.Tensor):
    """(w, h, cx, cy) of boxes (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h


def encode_boxes(
    boxes: torch.Tensor,
    anchors: torch.Tensor,
    weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Encode target ``boxes`` (..., 4) relative to ``anchors`` (..., 4) as
    (dx, dy, dw, dh), each multiplied by its weight (1/std)."""
    aw, ah, ax, ay = _center(anchors)
    gw, gh, gx, gy = _center(boxes)
    aw = torch.clamp(aw, min=1e-6)
    ah = torch.clamp(ah, min=1e-6)
    wx, wy, ww, wh_ = weights
    dx = wx * (gx - ax) / aw
    dy = wy * (gy - ay) / ah
    dw = ww * torch.log(torch.clamp(gw, min=1e-6) / aw)
    dh = wh_ * torch.log(torch.clamp(gh, min=1e-6) / ah)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    weights: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Apply regression ``deltas`` (..., 4) to ``anchors`` (..., 4).

    Dtypes promote as in JAX: bf16 deltas divided by a Python weight stay
    bf16 (so ``exp`` runs in bf16), and meet the f32 anchors in f32.
    """
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah

    wx, wy, ww, wh_ = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh_, max=BBOX_XFORM_CLIP)

    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah

    x1 = cx - 0.5 * w
    y1 = cy - 0.5 * h
    x2 = cx + 0.5 * w
    y2 = cy + 0.5 * h
    return torch.stack([x1, y1, x2, y2], dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip boxes (..., 4) to [0, width] x [0, height].  ``height`` and
    ``width`` are Python numbers or tensors broadcastable to
    ``boxes[..., 0]`` (per-image true sizes inside a padded batch)."""
    height = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    width = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.clamp(boxes[..., 0], min=0.0), width)
    y1 = torch.minimum(torch.clamp(boxes[..., 1], min=0.0), height)
    x2 = torch.minimum(torch.clamp(boxes[..., 2], min=0.0), width)
    y2 = torch.minimum(torch.clamp(boxes[..., 3], min=0.0), height)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def valid_box_mask(boxes: torch.Tensor, min_size: float = 0.0) -> torch.Tensor:
    """Boxes at least ``min_size`` wide and tall; at ``min_size <= 0``
    zero-extent boxes are still rejected."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    if min_size <= 0.0:
        return (w > 0.0) & (h > 0.0)
    return (w >= min_size) & (h >= min_size)
