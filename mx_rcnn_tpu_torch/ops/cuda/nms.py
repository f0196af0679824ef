"""Greedy NMS keep mask: CUDA kernel B4 and its plain torch version.

Replaces ``mx_rcnn_tpu/ops/pallas/nms.py::nms_mask_pallas``, the kernel
behind ``rpn.nms_impl="pallas"``.  Same contract as ``ops/nms.py::nms_mask``:
boxes (..., N, 4), scores (..., N) -> keep (..., N) bool in input order;
invalid and ``-inf`` lanes neither keep nor suppress; IoU is snapped to
2**-16 before ``> thresh``.  The stable score sort and the scatter back to
input order stay in torch around the kernel, as they stay in XLA around
the Pallas kernel; the kernel (``csrc/nms.cu``) sees sorted boxes.
Leading axes fold into independent problems of one launch, so the
proposal middle's (B, L, k) candidates take one launch a call.

:func:`nms_mask_cuda` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; :func:`nms_keep_sorted_plain` is the
plain version of the kernel itself.  ``nms_mask_cuda.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mx_rcnn_tpu_torch.geometry import snap
from mx_rcnn_tpu_torch.ops.cuda import _build
from mx_rcnn_tpu_torch.ops.nms import greedy_fixed_point


def nms_keep_sorted_plain(
    sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """What the kernel computes: sorted boxes (..., N, 4), valid (..., N)
    -> keep (..., N) in sorted order.  Areas unclamped, as the kernel."""
    n = sboxes.shape[-2]
    x1, y1, x2, y2 = sboxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iw = torch.clamp(
        torch.minimum(x2[..., :, None], x2[..., None, :])
        - torch.maximum(x1[..., :, None], x1[..., None, :]),
        min=0.0,
    )
    ih = torch.clamp(
        torch.minimum(y2[..., :, None], y2[..., None, :])
        - torch.maximum(y1[..., :, None], y1[..., None, :]),
        min=0.0,
    )
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    pos = union > 0.0
    iou = snap(torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0))
    upper = torch.ones((n, n), dtype=torch.bool, device=sboxes.device).triu(1)
    suppress = (
        (iou > iou_threshold) & upper & svalid[..., :, None] & svalid[..., None, :]
    )
    return greedy_fixed_point(suppress, svalid)


def _launch(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float):
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool:
        raise TypeError(
            f"nms kernel takes float32 boxes and bool valid, got {sboxes.dtype}, {svalid.dtype}"
        )
    if sboxes.shape[-1] != 4 or svalid.shape != sboxes.shape[:-1]:
        raise ValueError(
            f"nms kernel: boxes {tuple(sboxes.shape)} and valid "
            f"{tuple(svalid.shape)} do not match"
        )
    if svalid.device != sboxes.device:
        raise ValueError("nms kernel: boxes and valid on different devices")
    n = sboxes.shape[-2]
    lead = sboxes.shape[:-2]
    boxes = sboxes.reshape(-1, n, 4).contiguous()
    valid = svalid.reshape(-1, n).contiguous()  # bool: one byte, 0 or 1
    problems = boxes.shape[0]
    mask = torch.empty((problems, n, -(-n // 64)), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((problems, n), dtype=torch.bool, device=boxes.device)
    fn = _build.entry("nms", "nms_keep_sorted", _ARGTYPES)
    rc = fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
            problems, n, float(iou_threshold), _build.stream_ptr(boxes.device))
    _build.check("nms", rc, "nms_keep_sorted")
    nms_mask_cuda.launches += 1
    return keep.reshape(*lead, n)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def nms_keep_sorted_cuda(
    sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """The kernel alone on CUDA tensors (the plain version on CPU ones)."""
    if sboxes.device.type == "cpu":
        return nms_keep_sorted_plain(sboxes, svalid, iou_threshold)
    if sboxes.device.type != "cuda":
        raise ValueError(f"nms kernel: unsupported device {sboxes.device}")
    return _launch(sboxes, svalid, iou_threshold)


def nms_mask_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Drop-in for ``ops/nms.py::nms_mask`` through kernel B4."""
    finite = torch.isfinite(scores)
    valid = finite if valid is None else valid & finite
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(valid, -1, order)
    keep_sorted = nms_keep_sorted_cuda(sboxes, svalid, iou_threshold)
    return torch.zeros_like(svalid).scatter(-1, order, keep_sorted)


nms_mask_cuda.launches = 0
