"""Host-side instance-mask utilities: polygon fill, bilinear resize,
paste-back, the RLE codec and mask IoU (port of
``mx_rcnn_tpu/evalutil/masks.py``).

The JAX package fills polygons with ``cv2.fillPoly`` and resizes with
``cv2.resize``; the card's machine has neither cv2 nor PIL, so both are
written here in numpy:

* :func:`fill_polygons` follows ``cv2.fillPoly``'s rule for integer
  vertices: every edge is drawn as an 8-connected Bresenham line, and
  each scanline from the top vertex row to the one above the bottom is
  filled between its even-odd pairs of edge crossings, each tracked in
  16.16 fixed point from the edge's start, from the first pixel centre at
  or right of the left crossing to the last at or left of the right one:
  a pixel whose centre lies on an edge is inside.  A polygon on the
  canvas gets cv2's bits; one whose edges leave the canvas is clipped as
  cv2 clips lines, and may differ from cv2 along the canvas border
  (``tests/test_torch_mask.py`` states and bounds the share).
* :func:`resize_bilinear` is cv2 ``INTER_LINEAR`` on float32: half-pixel
  centres, edge samples clamped, a horizontal then a vertical pass with
  float32 weights.

Nothing here falls back: a missing segmentation rasterizes as its box
(:func:`gt_record_rles`, as in JAX), never as zeros.

:func:`rle_encode` and :func:`rle_iou` take the native library
(``mx_rcnn_tpu_torch/native``) when it is built, as JAX's do, and their
numpy code otherwise; the two give the same bits.

RLE format: column-major (Fortran order, as COCO) run lengths of
alternating 0/1 runs, starting with 0: {"size": (h, w), "counts":
uint32[]}.
"""

from __future__ import annotations

import numpy as np

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(h: int, w: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` on an ``h`` x ``w`` canvas: the segment's
    endpoints moved onto the canvas (``x += (a - y) * dx / dy`` truncated),
    and whether any of it lies on the canvas."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(x1: int, y1: int, x2: int, y2: int) -> tuple[np.ndarray, np.ndarray]:
    """The pixels of cv2's 8-connected line iterator from (x1, y1) to
    (x2, y2), left to right: one a step of the major axis, a minor step
    when the error term is negative, which in closed form is
    ``ceil((2 minor k - major) / (2 major))`` minor steps after k."""
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    ysign = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // (2 * major)) if major else k
    if steep:
        return x1 + m, y1 + ysign * k
    return x1 + k, y1 + ysign * m


def fill_polygons(polys, height: int, width: int) -> np.ndarray:
    """Polygons of rounded integer (x, y) vertices, each (n, 2) -> an
    (height, width) bool mask, filled together under the even-odd rule as
    ``cv2.fillPoly`` fills them (module docstring)."""
    out = np.zeros((height, width), bool)
    edges = []                          # (y0, y1, x at y0 in 16.16, dx a row)
    for poly in polys:
        pts = np.asarray(poly, np.int64).reshape(-1, 2)
        n = len(pts)
        for i in range(n):
            (x0, y0), (x1, y1) = pts[i - 1].tolist(), pts[i].tolist()
            # Crossings in 16.16 fixed point from the edge's start; an edge
            # that leaves the canvas runs along its clipped segment, extended
            # back to its own top row.
            c0, c1 = (x0 << _XY_SHIFT, y0), (x1 << _XY_SHIFT, y1)
            line = (x0, y0, x1, y1)
            if not all(0 <= v < lim for v, lim in ((x0, width), (x1, width),
                                                   (y0, height), (y1, height))):
                ok, *line = _clip_line(height, width, x0, y0, x1, y1)
                if line[1] != line[3]:
                    c0, c1 = (line[0] << _XY_SHIFT, line[1]), (line[2] << _XY_SHIFT, line[3])
                if not ok:
                    line = None
            if line is not None:
                xs, ys = _line_pixels(*line)
                on = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
                out[ys[on], xs[on]] = True
            if y0 == y1:
                continue
            dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
            if y0 < y1:
                edges.append((y0, y1, c0[0] + (y0 - c0[1]) * dx, dx))
            else:
                edges.append((y1, y0, c1[0] + (y1 - c1[1]) * dx, dx))
    if len(edges) < 2:
        return out
    e = np.asarray(edges, np.int64)
    y_lo, y_hi = int(e[:, 0].min()), min(int(e[:, 1].max()), height)
    for y in range(max(y_lo, 0), y_hi):
        act = e[(e[:, 0] <= y) & (e[:, 1] > y)]
        if len(act) < 2:
            continue
        xs = np.sort(act[:, 2] + (y - act[:, 0]) * act[:, 3])
        for xl, xr in zip(xs[0::2], xs[1::2]):
            a, b = int((xl + _XY_ONE - 1) >> _XY_SHIFT), int(xr >> _XY_SHIFT)
            if a < width and b >= 0:
                out[y, max(a, 0):min(b, width - 1) + 1] = True
    return out


def _trunc_div(a: int, b: int) -> int:
    """C integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W) float32 -> (height, width), cv2 ``INTER_LINEAR``'s rule:
    source coordinate ``(d + 0.5) * (in / out) - 0.5``, clamped to the
    first and last sample, float32 weights, rows then columns."""
    src = np.asarray(image, np.float32)

    def taps(n_in: int, n_out: int):
        f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f).astype(np.int64)
        frac = (f - i0).astype(np.float32)
        low, high = i0 < 0, i0 >= n_in - 1
        frac[low | high] = 0.0
        i0 = np.clip(i0, 0, n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, np.float32(1.0) - frac, frac

    x0, x1, ax0, ax1 = taps(src.shape[1], width)
    y0, y1, ay0, ay1 = taps(src.shape[0], height)
    rows = src[:, x0] * ax0 + src[:, x1] * ax1
    return rows[y0] * ay0[:, None] + rows[y1] * ay1[:, None]


def paste_mask(mask: np.ndarray, box: np.ndarray, height: int, width: int,
               threshold: float = 0.5) -> np.ndarray:
    """(M, M) probability mask + xyxy box -> (height, width) bool canvas:
    the M x M grid resized to the box's integer extent (floor of the top
    left to ceil of the bottom right, inclusive), thresholded, pasted
    clipped to the canvas."""
    x1, y1, x2, y2 = box
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)) + 1, int(np.ceil(y2)) + 1
    bw, bh = max(x2i - x1i, 1), max(y2i - y1i, 1)
    up = resize_bilinear(mask, bh, bw)
    out = np.zeros((height, width), bool)
    ys, xs = max(y1i, 0), max(x1i, 0)
    ye, xe = min(y2i, height), min(x2i, width)
    if ye > ys and xe > xs:
        out[ys:ye, xs:xe] = up[ys - y1i:ye - y1i, xs - x1i:xe - x1i] >= threshold
    return out


def rle_encode(binary: np.ndarray) -> dict:
    """(h, w) bool -> COCO-style column-major RLE (C++ when built)."""
    from mx_rcnn_tpu_torch.native.lib import rle_encode_native

    native = rle_encode_native(binary)
    if native is not None:
        return native
    h, w = binary.shape
    flat = np.asarray(binary, np.uint8).T.reshape(-1)  # Fortran order
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).astype(np.uint32)
    if flat.size and flat[0] == 1:  # the first run counts zeros
        counts = np.concatenate([[np.uint32(0)], counts])
    return {"size": (h, w), "counts": counts}


def rle_decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat.reshape(w, h).T.astype(bool)


def rle_area(rle: dict) -> int:
    return int(np.asarray(rle["counts"][1::2], np.int64).sum())


def _one_runs(rle: dict) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the RLE's runs of ones, as flat positions."""
    ends = np.cumsum(np.asarray(rle["counts"], np.int64))
    starts = ends - np.asarray(rle["counts"], np.int64)
    return starts[1::2], ends[1::2]


def rle_iou(dts: list[dict], gts: list[dict]) -> np.ndarray:
    """(n dts) x (m gts) mask IoU, float64, without decoding (C++ when
    built): for each gt, the count of its ones before a position is read
    at every det run's ends by one ``searchsorted``, so intersections are
    exact integers."""
    from mx_rcnn_tpu_torch.native.lib import rle_iou_native

    native = rle_iou_native(dts, gts)
    if native is not None:
        return native
    n, m = len(dts), len(gts)
    out = np.zeros((n, m))
    if n == 0 or m == 0:
        return out
    runs = [_one_runs(d) for d in dts]
    d_areas = np.array([rle_area(d) for d in dts], np.int64)
    lens = np.array([len(s) for s, _ in runs])
    d_start = np.concatenate([s for s, _ in runs])
    d_end = np.concatenate([e for _, e in runs])
    owner = np.repeat(np.arange(n), lens)
    for j, g in enumerate(gts):
        gs, ge = _one_runs(g)
        glen = ge - gs
        before = np.concatenate([[0], np.cumsum(glen)])     # ones before run k

        def ones_before(p):
            if not len(gs):
                return np.zeros_like(p)
            k = np.searchsorted(gs, p, side="right") - 1
            kc = np.maximum(k, 0)
            return np.where(k >= 0, before[kc] + np.minimum(p - gs[kc], glen[kc]), 0)

        inter = np.bincount(owner, ones_before(d_end) - ones_before(d_start), minlength=n)
        union = d_areas + int(glen.sum()) - inter
        out[:, j] = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return out


def rasterize_polygons(polys, height: int, width: int) -> np.ndarray:
    """COCO polygon list (image coordinates) -> (h, w) bool mask, the
    vertices rounded to integers as the JAX package rounds them."""
    pts = [np.asarray(p, np.float32).reshape(-1, 2).round().astype(np.int32) for p in polys]
    return fill_polygons(pts, height, width)


def gt_record_rles(rec) -> list:
    """One RLE a gt box of a roidb record: its polygons rasterized, its
    RLE dict as given, or, with no segmentation, the full box."""
    out = []
    for i in range(len(rec.boxes)):
        seg = rec.masks[i] if rec.masks is not None and i < len(rec.masks) else None
        if isinstance(seg, list):
            out.append(rle_encode(rasterize_polygons(seg, rec.height, rec.width)))
        elif isinstance(seg, dict):
            counts = seg["counts"]
            if isinstance(counts, list):
                out.append({"size": tuple(seg["size"]), "counts": np.asarray(counts, np.uint32)})
            else:
                out.append(rle_encode(rle_decode(seg)))
        else:
            canvas = np.zeros((rec.height, rec.width), bool)
            x1, y1, x2, y2 = np.asarray(rec.boxes[i], int)
            canvas[max(y1, 0):y2 + 1, max(x1, 0):x2 + 1] = True
            out.append(rle_encode(canvas))
    return out
