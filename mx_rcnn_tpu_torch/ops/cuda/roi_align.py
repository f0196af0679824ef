"""Multi-level ROIAlign forward: CUDA kernel B1 and its plain version.

Replaces ``mx_rcnn_tpu/ops/pallas/roi_align.py::multilevel_roi_align_pallas``,
the kernel behind ``rcnn.roi_align_impl="pallas"``.  Batched contract:
pyramid {level: (B, H_l, W_l, C)} (NHWC, consecutive levels), rois
(B, R, 4) f32 in image coordinates -> (B, R, S, S, C) in the feature
dtype (float32 or bfloat16).  The batch folds into one launch.

Level assignment stays in torch ahead of the launch (the port's
``fpn_level_assignment``, extent bound 38 cells); the kernel
(``csrc/roi_align.cu``) pools each roi from its level.  The plain version
is ``ops/roi_align.py::multilevel_roi_align``, taken only for CPU tensors.
``multilevel_roi_align_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mx_rcnn_tpu_torch.ops.cuda import _build
from mx_rcnn_tpu_torch.ops.roi_align import (
    MAX_EXTENT_CELLS,
    fpn_level_assignment,
    multilevel_roi_align,
)

_MAX_LEVELS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Pyramid(ctypes.Structure):
    """Mirror of ``struct Pyramid`` in csrc/roi_align.cu, passed by value."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * _MAX_LEVELS),
        ("h", ctypes.c_int * _MAX_LEVELS),
        ("w", ctypes.c_int * _MAX_LEVELS),
        ("level", ctypes.c_int * _MAX_LEVELS),
        ("num_levels", ctypes.c_int),
    ]


def multilevel_roi_align_plain(feature_pyramid, rois, output_size=7, sampling_ratio=2):
    """The plain torch version of the kernel (the XLA oracle's port)."""
    return multilevel_roi_align(feature_pyramid, rois, output_size, sampling_ratio)


def _check(feature_pyramid: dict[int, torch.Tensor], rois: torch.Tensor):
    levels = sorted(feature_pyramid)
    if not levels or len(levels) > _MAX_LEVELS:
        raise ValueError(f"roi_align kernel takes 1..{_MAX_LEVELS} levels, got {len(levels)}")
    if levels != list(range(levels[0], levels[-1] + 1)):
        raise ValueError(f"roi_align kernel needs consecutive levels, got {levels}")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"rois must be (B, R, 4) float32, got {tuple(rois.shape)} {rois.dtype}")
    first = feature_pyramid[levels[0]]
    if first.dtype not in _DTYPES:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16, got {first.dtype}")
    b, c = rois.shape[0], first.shape[-1]
    for l in levels:
        f = feature_pyramid[l]
        if f.device != rois.device:
            raise ValueError(f"level {l} on {f.device}, rois on {rois.device}")
        if f.dtype != first.dtype or f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(
                f"level {l}: {tuple(f.shape)} {f.dtype} does not match (B={b}, C={c}) {first.dtype}"
            )
        if not f.is_contiguous():
            raise ValueError(f"level {l} is not contiguous NHWC memory")
    return levels, b, c


def multilevel_roi_align_cuda(
    feature_pyramid: dict[int, torch.Tensor],
    rois: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Kernel B1 on CUDA tensors; the plain version on CPU tensors."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_plain(feature_pyramid, rois, output_size, sampling_ratio)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align kernel: unsupported device {rois.device}")
    levels, b, c = _check(feature_pyramid, rois)
    if not rois.is_contiguous():
        rois = rois.contiguous()
    r = rois.shape[1]
    level_idx = (
        fpn_level_assignment(rois, levels[0], levels[-1], max_extent_cells=MAX_EXTENT_CELLS)
        - levels[0]
    ).to(torch.int32).contiguous()
    dtype = feature_pyramid[levels[0]].dtype
    out = torch.empty((b, r, output_size, output_size, c), dtype=dtype, device=rois.device)

    pyr = _Pyramid()
    for i, l in enumerate(levels):
        f = feature_pyramid[l]
        pyr.ptr[i] = f.data_ptr()
        pyr.h[i], pyr.w[i], pyr.level[i] = f.shape[1], f.shape[2], l
    pyr.num_levels = len(levels)

    lib = _build.load("roi_align")
    fn = lib.roi_align_forward
    fn.argtypes = [_Pyramid] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(pyr, rois.data_ptr(), level_idx.data_ptr(), out.data_ptr(), b * r, r, c,
            output_size, sampling_ratio, _DTYPES[dtype], _build.stream_ptr(rois.device))
    _build.check(lib, rc, "roi_align_forward")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0
