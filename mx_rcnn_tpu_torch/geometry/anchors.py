"""Anchor generation (port of ``mx_rcnn_tpu/geometry/anchors.py``).

Host numpy: the grids are a pure function of (stride, H, W), computed in
float64 and cast to float32 exactly as the JAX package does, so both
packages consume bit-identical anchors.  Order is (H, W, A) row-major,
matching how the RPN head flattens its (H, W, A) outputs.
"""

from __future__ import annotations

import numpy as np


def generate_base_anchors(
    base_size: int = 16, ratios=(0.5, 1.0, 2.0), scales=(8, 16, 32)
) -> np.ndarray:
    """The len(ratios)*len(scales) base anchors centred at base_size/2."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    cx = cy = 0.5 * base_size
    size = float(base_size * base_size)
    ws = np.sqrt(size / ratios)
    hs = ws * ratios
    ws = (ws[:, None] * scales[None, :]).reshape(-1)
    hs = (hs[:, None] * scales[None, :]).reshape(-1)
    return np.stack(
        [cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs], axis=1
    ).astype(np.float32)


def shifted_anchors_np(base_anchors, stride: int, height: int, width: int):
    """Tile base anchors over an H x W grid -> (H*W*k, 4) float32."""
    base = np.asarray(base_anchors, dtype=np.float32)
    shift_x = np.arange(width, dtype=np.float32) * stride
    shift_y = np.arange(height, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1)  # (H, W, 4)
    out = shifts[:, :, None, :] + base[None, None, :, :]  # (H, W, k, 4)
    return out.reshape(-1, 4)
