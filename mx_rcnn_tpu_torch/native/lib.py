"""ctypes bindings of the native library, with numpy versions (port of
``mx_rcnn_tpu/native/lib.py``).

Each entry point computes the same bits built or unbuilt:
``tests/test_torch_native.py`` holds the library against the numpy
versions and against the JAX package's library.  The library is built at
first use (``native/build.py``); where that fails (no compiler) the
failure is cached and the numpy versions serve.  Each entry point counts
its calls into the library in its ``calls`` attribute (the numpy
versions are not counted), as a CUDA wrapper counts its ``launches``.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("mx_rcnn_tpu_torch")

_LIB = None  # None: not tried yet; False: the build or the load failed; else the CDLL


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB or None
    from mx_rcnn_tpu_torch.native.build import build

    try:
        lib = ctypes.CDLL(str(build(verbose=False)))
    except (OSError, subprocess.SubprocessError) as e:   # no g++, a failed compile or load
        # Cached: callers sit on per-image paths; one attempt a process.
        log.warning("native library unavailable (%s: %s); using the numpy versions",
                    type(e).__name__, e)
        _LIB = False
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.cpu_nms.restype = ctypes.c_int
    lib.cpu_nms.argtypes = [f32p, i32p, ctypes.c_int, ctypes.c_float, i32p]
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p]
    lib.rle_iou.restype = None
    lib.rle_iou.argtypes = [u32p, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"), i32p,
                            ctypes.c_int, ctypes.c_int,
                            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.letterbox_normalize.restype = None
    lib.letterbox_normalize.argtypes = [u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, f32p, f32p]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def cpu_nms(boxes: np.ndarray, scores: np.ndarray, threshold: float) -> np.ndarray:
    """Greedy NMS; the kept indices in score order (a stable sort), with
    the reference's ``cpu_nms.pyx`` semantics (+1 pixel areas)."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    order = np.argsort(-np.asarray(scores), kind="mergesort").astype(np.int32)
    n = len(boxes)
    lib = _load()
    if lib is None or n == 0:
        return _py_nms(boxes, order, threshold)
    keep = np.empty(n, np.int32)
    kept = lib.cpu_nms(boxes, order, n, float(threshold), keep)
    cpu_nms.calls += 1
    return keep[:kept].copy()


def _py_nms(boxes: np.ndarray, order: np.ndarray, threshold: float) -> np.ndarray:
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(0, x2 - x1 + 1) * np.maximum(0, y2 - y1 + 1)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order])
        yy1 = np.maximum(y1[i], y1[order])
        xx2 = np.minimum(x2[i], x2[order])
        yy2 = np.minimum(y2[i], y2[order])
        inter = np.maximum(0, xx2 - xx1 + 1) * np.maximum(0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order] - inter)
        suppressed[order[iou > threshold]] = True
    return np.asarray(keep, np.int32)


def rle_encode_native(binary: np.ndarray) -> Optional[dict]:
    """COCO column-major RLE of an (h, w) mask in C++ (uint32 counts);
    None when the library is unavailable (``evalutil/masks.py::rle_encode``
    then encodes in numpy)."""
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(binary, np.uint8)
    h, w = m.shape
    counts = np.empty(h * w + 1, np.uint32)
    n = lib.rle_encode(m, h, w, counts)
    rle_encode_native.calls += 1
    return {"size": (h, w), "counts": counts[:n].copy()}


def rle_iou_native(dts: list, gts: list) -> Optional[np.ndarray]:
    """(n dts) x (m gts) mask IoU, float64, in C++; None when the library
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    alls = list(dts) + list(gts)
    lengths = np.asarray([len(r["counts"]) for r in alls], np.int32)
    offsets = np.zeros(len(alls), np.int64)
    if len(alls) > 1:
        offsets[1:] = np.cumsum(lengths[:-1])
    flat = (np.concatenate([np.asarray(r["counts"], np.uint32) for r in alls])
            if alls else np.zeros(0, np.uint32))
    out = np.zeros((len(dts), len(gts)), np.float64)
    if len(dts) and len(gts):
        lib.rle_iou(np.ascontiguousarray(flat), offsets, lengths, len(dts), len(gts), out)
        rle_iou_native.calls += 1
    return out


def letterbox_normalize(image: np.ndarray, canvas_hw: tuple[int, int], nh: int, nw: int,
                        scale: float, mean: tuple[float, float, float],
                        std: tuple[float, float, float]) -> Optional[np.ndarray]:
    """Resize a uint8 (H, W, 3) image to (nh, nw) (cv2 ``INTER_LINEAR``'s
    half-pixel rule, per-axis ratios), paste it top-left into a
    ``canvas_hw`` float32 canvas and normalize channelwise, the rest of the
    canvas normalized zeros; None for any other input.  The C++ fuses the
    passes; unbuilt, :func:`_py_letterbox_normalize` gives the same bits.
    ``scale`` is the box scale, unused by the pixels."""
    if image.dtype != np.uint8 or image.ndim != 3:
        return None
    lib = _load()
    if lib is None:
        return _py_letterbox_normalize(image, canvas_hw, nh, nw, mean, std)
    sh, sw = image.shape[:2]
    dh, dw = canvas_hw
    dst = np.empty((dh, dw, 3), np.float32)
    lib.letterbox_normalize(np.ascontiguousarray(image), sh, sw, dst, dh, dw, int(nh), int(nw),
                            float(scale), np.asarray(mean, np.float32),
                            np.asarray(std, np.float32))
    letterbox_normalize.calls += 1
    return dst


def _axis_taps(n_dst: int, n_src: int, n_resized: int):
    """The C++'s source taps along one axis in float32: the first and the
    next sample and the weight of the next, for ``n_dst`` outputs."""
    f32 = np.float32
    ratio = f32(n_src) / f32(n_resized if n_resized > 0 else 1)
    s = (np.arange(n_dst).astype(f32) + f32(0.5)) * ratio - f32(0.5)
    s = np.maximum(f32(0), np.minimum(s, f32(n_src) - f32(1)))
    i0 = s.astype(np.int64)
    return i0, np.minimum(i0 + 1, n_src - 1), s - i0.astype(f32)


def _py_letterbox_normalize(image: np.ndarray, canvas_hw: tuple[int, int], nh: int, nw: int,
                            mean, std) -> np.ndarray:
    """numpy version of the C++ ``letterbox_normalize``, its float32
    operations in the same order, so its bits are the library's."""
    f32 = np.float32
    sh, sw = image.shape[:2]
    dh, dw = canvas_hw
    mean, std = np.asarray(mean, f32), np.asarray(std, f32)
    inv_std = f32(1) / std
    dst = np.empty((dh, dw, 3), f32)
    dst[:] = -mean * inv_std
    ny, nx = min(int(nh), dh), min(int(nw), dw)
    if ny <= 0 or nx <= 0:
        return dst
    y0, y1, ly = _axis_taps(ny, sh, int(nh))
    x0, x1, lx = _axis_taps(nx, sw, int(nw))
    src = image.astype(f32)
    ly, lx = ly[:, None, None], lx[None, :, None]
    top = (f32(1) - lx) * src[y0][:, x0] + lx * src[y0][:, x1]
    bottom = (f32(1) - lx) * src[y1][:, x0] + lx * src[y1][:, x1]
    v = (f32(1) - ly) * top + ly * bottom
    dst[:ny, :nx] = (v - mean) * inv_std
    return dst


for _fn in (cpu_nms, rle_encode_native, rle_iou_native, letterbox_normalize):
    _fn.calls = 0
