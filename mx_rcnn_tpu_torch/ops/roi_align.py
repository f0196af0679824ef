"""Single- and multi-level ROIAlign in plain torch (port of
``mx_rcnn_tpu/ops/roi_align.py``).

:func:`roi_align` pools one feature map at a fixed ``spatial_scale``, the
XLA path the JAX package takes for the single-level C4 recipe.  Over the
one-level pyramid ``{4: f}``, :func:`multilevel_roi_align` assigns every
roi to level 4 and scales by 2**-4 = 1/16, so it computes the same bits;
the port's C4 graph pools through B1 and B2 on that pyramid.

:func:`multilevel_roi_align` is the FPN oracle: the flattened-pyramid gather
of the JAX XLA path, with the batch written out where JAX vmaps.  It is
the plain version of the CUDA kernel B1 (``ops/cuda/roi_align.py``) and
the CPU path of ``rcnn.roi_align_impl="pallas"``;
:func:`multilevel_roi_align_bwd`, its transpose, is the plain version of
kernel B2.

Semantics (Detectron ROIAlign): each of the S x S bins averages
``sampling_ratio**2`` bilinear samples; samples outside (-1, H) x (-1, W)
contribute zero, samples inside clamp to the cell range.  Interpolation
and accumulation run in float32, with one cast back to the feature dtype.
"""

from __future__ import annotations

import torch

# Bound on a roi's extent in feature cells at its assigned level.  Equals
# the JAX Pallas kernel's window - 10 (POOL_WINDOW = 48), so both packages
# assign every roi to the same level.
MAX_EXTENT_CELLS = 38


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once on every device.  For a Python-number
    divisor, torch's CUDA division multiplies by the rounded reciprocal,
    which can land one ulp away from the CPU's (and JAX's) quotient."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def fpn_level_assignment(
    rois: torch.Tensor,
    min_level: int = 2,
    max_level: int = 5,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
    max_extent_cells: int | None = MAX_EXTENT_CELLS,
) -> torch.Tensor:
    """FPN eq. 1, k = k0 + floor(log2(sqrt(area) / 224)), clamped, then
    raised until the roi's extent fits ``max_extent_cells``.  rois
    (..., 4) -> int32 levels (...)."""
    w = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-6)
    h = torch.clamp(rois[..., 3] - rois[..., 1], min=1e-6)
    k = canonical_level + torch.log2(true_div(torch.sqrt(w * h), canonical_scale))
    k = torch.floor(k).to(torch.int32)
    if max_extent_cells is not None:
        extent = torch.maximum(w, h)
        k_fit = torch.ceil(torch.log2(true_div(extent, max_extent_cells))).to(torch.int32)
        k = torch.maximum(k, k_fit)
    return torch.clamp(k, min_level, max_level)


def _level_tables(level_shapes, dev):
    """Per-level (H, W) as float32 and int64 tensors, and each level's
    base row in the flattened pyramid (B, sum H*W, C)."""
    hs, ws, bases, off = [], [], [], 0
    for h, w in level_shapes:
        hs.append(h)
        ws.append(w)
        bases.append(off)
        off += h * w
    return (
        torch.tensor(hs, dtype=torch.float32, device=dev),
        torch.tensor(ws, dtype=torch.float32, device=dev),
        torch.tensor(ws, dtype=torch.int64, device=dev),
        torch.tensor(bases, dtype=torch.int64, device=dev),
        off,
    )


def _sample_grid(rois, assignment, output_size: int):
    """Per roi: its corner and bin size at its level ((B, R) each)."""
    scale = 2.0 ** (-assignment.to(torch.float32))
    scaled = rois * scale[..., None]
    x1, y1 = scaled[..., 0], scaled[..., 1]
    rw = torch.clamp(scaled[..., 2] - x1, min=1.0)
    rh = torch.clamp(scaled[..., 3] - y1, min=1.0)
    return x1, y1, true_div(rw, output_size), true_div(rh, output_size)


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """One feature map (B, H, W, C), rois (B, R, 4) in image coordinates
    -> (B, R, S, S, C) in the features' dtype."""
    b, h, w, c = features.shape
    r = rois.shape[1]
    dev = rois.device
    scaled = rois * spatial_scale
    x1, y1 = scaled[..., 0], scaled[..., 1]
    rw = torch.clamp(scaled[..., 2] - x1, min=1.0)
    rh = torch.clamp(scaled[..., 3] - y1, min=1.0)
    bin_w, bin_h = true_div(rw, output_size), true_div(rh, output_size)
    h_r = torch.full((b, r), float(h), device=dev)
    w_r = torch.full((b, r), float(w), device=dev)
    wi_r = torch.full((b, r), w, dtype=torch.int64, device=dev)
    base_r = torch.zeros((b, r), dtype=torch.int64, device=dev)
    flat = features.reshape(b, h * w, c)
    return _pool(flat, h_r, w_r, wi_r, base_r, x1, y1, bin_w, bin_h, output_size,
                 sampling_ratio)


def _pool(flat, h_r, w_r, wi_r, base_r, x1, y1, bin_w, bin_h, output_size: int,
          sampling_ratio: int) -> torch.Tensor:
    """Average the ``sampling_ratio**2`` bilinear samples of each of the
    S x S bins of each roi (per-roi corner, bin size, map bounds, pitch and
    base row in ``flat`` (B, N, C)), in float32, cast once."""
    b, r = x1.shape
    bins = torch.arange(output_size, dtype=torch.float32, device=x1.device)
    out = torch.zeros((b, r, output_size, output_size, flat.shape[-1]), dtype=torch.float32,
                      device=x1.device)
    for iy in range(sampling_ratio):
        fy = (iy + 0.5) / sampling_ratio
        sy = y1[..., None] + (bins + fy) * bin_h[..., None]       # (B, R, S)
        for ix in range(sampling_ratio):
            fx = (ix + 0.5) / sampling_ratio
            sx = x1[..., None] + (bins + fx) * bin_w[..., None]
            out = out + _bilinear_gather_flat(flat, h_r, w_r, wi_r, base_r, sy, sx)
    return true_div(out, sampling_ratio * sampling_ratio).to(flat.dtype)


def multilevel_roi_align(
    feature_pyramid: dict[int, torch.Tensor],
    rois: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    max_extent_cells: int | None = MAX_EXTENT_CELLS,
) -> torch.Tensor:
    """pyramid {level: (B, H_l, W_l, C)} (stride 2**level, consecutive
    levels), rois (B, R, 4) -> (B, R, S, S, C) in the features' dtype."""
    levels = sorted(feature_pyramid)
    b = rois.shape[0]
    c = feature_pyramid[levels[0]].shape[-1]
    flat = torch.cat(
        [feature_pyramid[l].reshape(b, -1, c) for l in levels], dim=1
    )                                                     # (B, sum HW, C)
    dev = rois.device
    hs, ws_f, ws_i, bases, _ = _level_tables(
        [feature_pyramid[l].shape[1:3] for l in levels], dev)

    assignment = fpn_level_assignment(
        rois, min_level=levels[0], max_level=levels[-1],
        max_extent_cells=max_extent_cells,
    )                                                     # (B, R)
    li = (assignment - levels[0]).long()
    return _pool(flat, hs[li], ws_f[li], ws_i[li], bases[li],
                 *_sample_grid(rois, assignment, output_size), output_size, sampling_ratio)


def _taps(h_r, w_r, sy, sx):
    """Bilinear taps of the samples at (sy (B,R,S), sx (B,R,S)): the
    inside mask (B,R,S,S), tap rows y0, y1 and columns x0, x1 (int64) and
    the fractional offsets ly, lx."""
    inside = (
        (sy[..., :, None] > -1.0)
        & (sy[..., :, None] < h_r[..., None, None])
        & (sx[..., None, :] > -1.0)
        & (sx[..., None, :] < w_r[..., None, None])
    )                                                     # (B, R, S, S)
    y = torch.minimum(torch.clamp(sy, min=0.0), h_r[..., None] - 1)
    x = torch.minimum(torch.clamp(sx, min=0.0), w_r[..., None] - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = y - y0
    lx = x - x0
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.minimum(y0i + 1, h_r[..., None].long() - 1)
    x1i = torch.minimum(x0i + 1, w_r[..., None].long() - 1)
    return inside, y0i, y1i, x0i, x1i, ly, lx


def _flat_index(base_r, wi_r, yi, xi):
    """Rows (B, R, S, S) of taps (yi (B,R,S), xi (B,R,S)) in the
    flattened pyramid."""
    return base_r[..., None, None] + yi[..., :, None] * wi_r[..., None, None] + xi[..., None, :]


def _bilinear_gather_flat(flat, h_r, w_r, wi_r, base_r, sy, sx):
    """Bilinear samples at (sy (B,R,S), sx (B,R,S)) from the flattened
    pyramid (B, N, C) with per-roi bounds, pitch and base -> (B,R,S,S,C)."""
    inside, y0i, y1i, x0i, x1i, ly, lx = _taps(h_r, w_r, sy, sx)
    b, n, c = flat.shape

    def gather(yi, xi):
        idx = _flat_index(base_r, wi_r, yi, xi)           # (B, R, S, S)
        g = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(b, -1, c))
        return g.reshape(*idx.shape, c)

    wy0 = (1.0 - ly)[..., :, None, None]
    wy1 = ly[..., :, None, None]
    wx0 = (1.0 - lx)[..., None, :, None]
    wx1 = lx[..., None, :, None]
    val = (
        gather(y0i, x0i) * wy0 * wx0
        + gather(y0i, x1i) * wy0 * wx1
        + gather(y1i, x0i) * wy1 * wx0
        + gather(y1i, x1i) * wy1 * wx1
    )
    return val * inside[..., None]


def multilevel_roi_align_bwd(
    level_shapes: dict[int, tuple[int, int]],
    dtype: torch.dtype,
    rois: torch.Tensor,
    level_idx: torch.Tensor,
    g: torch.Tensor,
    sampling_ratio: int = 2,
) -> dict[int, torch.Tensor]:
    """The transpose of :func:`multilevel_roi_align` with respect to the
    pyramid: level_shapes {level: (H_l, W_l)}, rois (B, R, 4), level_idx
    (B, R) (each roi's index into the sorted levels, as the forward
    assigned it), the cotangent g (B, R, S, S, C) -> {level: (B, H_l, W_l,
    C)} in ``dtype``.  Every bilinear tap of every sample adds
    ``(g / sr**2) * (wy * wx)`` in float32 (``index_add_``), cast once."""
    levels = sorted(level_shapes)
    b, r, s, _, c = g.shape
    dev = rois.device
    hs, ws_f, ws_i, bases, total = _level_tables([level_shapes[l] for l in levels], dev)
    li = level_idx.long()
    h_r, w_r, wi_r, base_r = hs[li], ws_f[li], ws_i[li], bases[li]
    x1, y1, bin_w, bin_h = _sample_grid(rois, li + levels[0], s)
    bins = torch.arange(s, dtype=torch.float32, device=dev)
    gs = true_div(g.to(torch.float32), sampling_ratio * sampling_ratio)
    image_base = (torch.arange(b, device=dev) * total)[:, None, None, None]
    flat = torch.zeros((b * total, c), dtype=torch.float32, device=dev)
    for iy in range(sampling_ratio):
        fy = (iy + 0.5) / sampling_ratio
        sy = y1[..., None] + (bins + fy) * bin_h[..., None]
        for ix in range(sampling_ratio):
            fx = (ix + 0.5) / sampling_ratio
            sx = x1[..., None] + (bins + fx) * bin_w[..., None]
            inside, y0i, y1i, x0i, x1i, ly, lx = _taps(h_r, w_r, sy, sx)
            wy0, wx0 = 1.0 - ly, 1.0 - lx
            for yi, xi, wy, wx in ((y0i, x0i, wy0, wx0), (y0i, x1i, wy0, lx),
                                   (y1i, x0i, ly, wx0), (y1i, x1i, ly, lx)):
                weight = (wy[..., :, None] * wx[..., None, :]) * inside
                rows = image_base + _flat_index(base_r, wi_r, yi, xi)
                flat.index_add_(0, rows.reshape(-1), (gs * weight[..., None]).reshape(-1, c))
    out, off = {}, 0
    flat = flat.reshape(b, total, c)
    for l in levels:
        h, w = level_shapes[l]
        out[l] = flat[:, off:off + h * w].reshape(b, h, w, c).to(dtype)
        off += h * w
    return out
