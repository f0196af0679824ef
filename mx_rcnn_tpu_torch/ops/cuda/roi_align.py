"""Multi-level ROIAlign: CUDA kernels B1 (forward) and B2 (backward),
their plain versions, and the autograd ``Function`` that joins them.

B1 replaces ``mx_rcnn_tpu/ops/pallas/roi_align.py::multilevel_roi_align_pallas``,
the kernel behind ``rcnn.roi_align_impl="pallas"``.  Batched contract:
pyramid {level: (B, H_l, W_l, C)} (NHWC, consecutive levels), rois
(B, R, 4) f32 in image coordinates -> (B, R, S, S, C) in the feature
dtype (float32 or bfloat16).  The batch folds into one launch: a block
a roi, whose tap tables are built once in shared memory, eight channels a
thread (one where C is not a multiple of 8; ``csrc/roi_align.cu``).

B2 replaces ``multilevel_roi_align_bwd_pallas``, the backward behind
``rcnn.roi_align_bwd_impl="pallas"``: the cotangent (B, R, S, S, C) ->
one gradient per level (B, H_l, W_l, C), accumulated in f32 and cast once
to the feature dtype, deterministic (``csrc/roi_align_bwd.cu``).  Its
first launch bins the rois into per-tile lists (:func:`roi_tile_lists_cuda`,
plain version :func:`roi_tile_lists_plain`), its second walks each
tile's list.

Level assignment stays in torch ahead of the launch (the port's
``fpn_level_assignment``, extent bound 38 cells); :class:`MultilevelRoiAlign`
assigns once in its forward and hands the same levels to B2.  The plain
versions are ``ops/roi_align.py::multilevel_roi_align`` and
``multilevel_roi_align_bwd``, taken only for CPU tensors.  Each kernel
wrapper's ``.launches`` counts its kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mx_rcnn_tpu_torch.ops.cuda import _build
from mx_rcnn_tpu_torch.ops.roi_align import (
    MAX_EXTENT_CELLS,
    _sample_grid,
    fpn_level_assignment,
    multilevel_roi_align,
    multilevel_roi_align_bwd,
)

_MAX_LEVELS = 8
FWD_MAX_SAMPLES = 64  # B1's tap tables: output_size * sampling_ratio an axis
TILE = 8  # B2's output tile edge in cells (csrc/roi_align_bwd.cu kTile)
BWD_GROUPS = 16  # B2's 8-channel groups a block: a 128-channel slab
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


class _GradPyramid(ctypes.Structure):
    """Mirror of ``struct GradPyramid`` in csrc/roi_align_bwd.cu."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * _MAX_LEVELS),
        ("h", ctypes.c_int * _MAX_LEVELS),
        ("w", ctypes.c_int * _MAX_LEVELS),
        ("level", ctypes.c_int * _MAX_LEVELS),
        ("tiles_x", ctypes.c_int * _MAX_LEVELS),
        ("tile_start", ctypes.c_int * (_MAX_LEVELS + 1)),
        ("num_levels", ctypes.c_int),
    ]


def multilevel_roi_align_plain(feature_pyramid, rois, output_size=7, sampling_ratio=2):
    """The plain torch version of B1 (the XLA oracle's port)."""
    return multilevel_roi_align(feature_pyramid, rois, output_size, sampling_ratio)


# The plain torch version of B2: the transpose of the plain forward, f32
# accumulation (``index_add_``), one cast to the feature dtype.
multilevel_roi_align_bwd_plain = multilevel_roi_align_bwd


def roi_level_index(rois: torch.Tensor, levels) -> torch.Tensor:
    """(B, R) int32 index of each roi's level into the sorted ``levels``."""
    return (
        fpn_level_assignment(rois, levels[0], levels[-1], max_extent_cells=MAX_EXTENT_CELLS)
        - levels[0]
    ).to(torch.int32).contiguous()


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
    level_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel B1 on CUDA tensors; the plain version on CPU tensors.
    ``level_idx`` (B, R) int32 from :func:`roi_level_index`, computed here
    when not given."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_plain(feature_pyramid, rois, output_size, sampling_ratio)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align kernel: unsupported device {rois.device}")
    levels, b, c = _check(feature_pyramid, rois)
    if not rois.is_contiguous():
        rois = rois.contiguous()
    r = rois.shape[1]
    if level_idx is None:
        level_idx = roi_level_index(rois, levels)
    _check_level_idx(level_idx, rois)
    if output_size * sampling_ratio > FWD_MAX_SAMPLES or min(output_size, sampling_ratio) < 1:
        raise ValueError(f"roi_align kernel: output_size * sampling_ratio must be 1.."
                         f"{FWD_MAX_SAMPLES}, got {output_size} * {sampling_ratio}")
    dtype = feature_pyramid[levels[0]].dtype
    out = torch.empty((b, r, output_size, output_size, c), dtype=dtype, device=rois.device)

    pyr = _Pyramid()
    for i, l in enumerate(levels):
        f = feature_pyramid[l]
        if f.shape[1] * f.shape[2] * c >= 2**31:
            raise ValueError(f"roi_align kernel: level {l} holds 2**31 or more elements an image")
        pyr.ptr[i] = f.data_ptr()
        pyr.h[i], pyr.w[i], pyr.level[i] = f.shape[1], f.shape[2], l
    pyr.num_levels = len(levels)
    # Eight channels a thread: C a multiple of 8 and 16-byte aligned rows.
    vec = c % 8 == 0 and all(p % 16 == 0 for p in (*pyr.ptr[:len(levels)], out.data_ptr()))

    fn = _build.entry("roi_align", "roi_align_forward",
                      [_Pyramid] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    rc = fn(pyr, rois.data_ptr(), level_idx.data_ptr(), out.data_ptr(), b * r, r, c,
            output_size, sampling_ratio, _DTYPES[dtype], int(vec), _build.stream_ptr(rois.device))
    _build.check("roi_align", rc, "roi_align_forward")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def _check_level_idx(level_idx: torch.Tensor, rois: torch.Tensor) -> None:
    if (level_idx.dtype != torch.int32 or level_idx.shape != rois.shape[:2]
            or level_idx.device != rois.device or not level_idx.is_contiguous()):
        raise ValueError(
            f"level_idx must be contiguous int32 {tuple(rois.shape[:2])} on {rois.device}, "
            f"got {level_idx.dtype} {tuple(level_idx.shape)} on {level_idx.device}"
        )


def roi_tile_lists_plain(
    level_shapes: dict[int, tuple[int, int]],
    rois: torch.Tensor,
    level_idx: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    tile: int = TILE,
) -> torch.Tensor:
    """B2's binning pass in plain torch: which rois each output tile must
    visit.  level_shapes {level: (H_l, W_l)} (consecutive levels), rois
    (B, R, 4) f32, level_idx (B, R) int32 -> (B, T, ceil(R / 32)) int32
    bitsets, T the ``tile`` x ``tile`` tiles of every level in level order
    (row-major within a level): bit r % 32 of word r / 32 is set when roi
    r's sample footprint at its level (the cells its first and last samples
    can tap, as ``csrc/roi_align_bwd.cu::tap_span``) reaches the tile.  A
    bitset is the tile's roi list in index order."""
    levels = sorted(level_shapes)
    b, r = rois.shape[:2]
    dev = rois.device
    li = level_idx.long()
    hs = torch.tensor([level_shapes[l][0] for l in levels], dtype=torch.float32, device=dev)
    ws = torch.tensor([level_shapes[l][1] for l in levels], dtype=torch.float32, device=dev)
    x1, y1, bin_w, bin_h = _sample_grid(rois, li + levels[0], output_size)
    sr = torch.tensor(float(sampling_ratio), dtype=torch.float32, device=dev)

    def sample(start, bin_, p, i):  # csrc/roi_align_bwd.cu::sample_at
        f = torch.tensor(i + 0.5, dtype=torch.float32, device=dev) / sr
        return start + (torch.tensor(float(p), dtype=torch.float32, device=dev) + f) * bin_

    def span(lo, hi, n):  # csrc/roi_align_bwd.cu::tap_span, in tiles
        first = torch.floor(torch.minimum(torch.clamp(lo, min=0.0), n - 1)).long()
        last = torch.minimum(
            torch.floor(torch.minimum(torch.clamp(hi, min=0.0), n - 1)).long() + 1,
            n.long() - 1)
        return torch.div(first, tile, rounding_mode="floor"), torch.div(
            last, tile, rounding_mode="floor")

    ly0, ly1 = span(sample(y1, bin_h, 0, 0),
                    sample(y1, bin_h, output_size - 1, sampling_ratio - 1), hs[li])
    lx0, lx1 = span(sample(x1, bin_w, 0, 0),
                    sample(x1, bin_w, output_size - 1, sampling_ratio - 1), ws[li])
    member = []
    for i, l in enumerate(levels):
        h, w = level_shapes[l]
        ty = torch.arange(-(-h // tile), device=dev)[:, None]
        tx = torch.arange(-(-w // tile), device=dev)[None, :]
        on = ((li == i)[..., None, None]
              & (ly0[..., None, None] <= ty) & (ty <= ly1[..., None, None])
              & (lx0[..., None, None] <= tx) & (tx <= lx1[..., None, None]))
        member.append(on.reshape(b, r, -1))
    member = torch.cat(member, dim=-1).transpose(1, 2)        # (B, T, R)
    words = -(-r // 32)
    member = torch.nn.functional.pad(member, (0, words * 32 - r))
    bits = (member.reshape(*member.shape[:2], words, 32).long()
            << torch.arange(32, device=dev)).sum(-1)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def _grad_pyramid(level_shapes, b: int, c: int, dtype, dev, tile: int):
    """The output maps {level: (B, H_l, W_l, C)} and their ``_GradPyramid``."""
    out, pyr, start = {}, _GradPyramid(), 0
    for i, l in enumerate(sorted(level_shapes)):
        h, w = (int(x) for x in level_shapes[l])
        out[l] = torch.empty((b, h, w, c), dtype=dtype, device=dev)
        pyr.ptr[i] = out[l].data_ptr()
        pyr.h[i], pyr.w[i], pyr.level[i] = h, w, l
        pyr.tiles_x[i] = -(-w // tile)
        pyr.tile_start[i] = start
        start += -(-h // tile) * pyr.tiles_x[i]
    pyr.tile_start[len(out)] = start
    pyr.num_levels = len(out)
    return out, pyr


def _check_bwd_levels(level_shapes) -> None:
    levels = sorted(level_shapes)
    if not levels or len(levels) > _MAX_LEVELS or levels != list(
            range(levels[0], levels[-1] + 1)):
        raise ValueError(f"roi_align_bwd kernel needs 1..{_MAX_LEVELS} consecutive levels, "
                         f"got {levels}")


def _bwd_rois(rois: torch.Tensor) -> torch.Tensor:
    """Checked (B, R, 4) f32 rois with 16-byte aligned rows, as B2 reads
    each roi's corners in one load."""
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"rois must be (B, R, 4) float32, got {tuple(rois.shape)} {rois.dtype}")
    rois = rois.contiguous()
    return rois if rois.data_ptr() % 16 == 0 else rois.clone()


@functools.cache
def _bwd_entry(symbol: str, argtypes: tuple):
    """An entry point of csrc/roi_align_bwd.cu, whose tile edge must be
    the wrapper's."""
    tile = _build.entry("roi_align_bwd", "roi_align_bwd_tile", [])()
    if tile != TILE:
        raise _build.KernelError(f"roi_align_bwd.cu tiles by {tile}, the wrapper by {TILE}")
    return _build.entry("roi_align_bwd", symbol, list(argtypes))


def roi_tile_lists_cuda(
    level_shapes: dict[int, tuple[int, int]],
    rois: torch.Tensor,
    level_idx: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """B2's binning pass alone (the first of its two launches) on CUDA
    tensors; :func:`roi_tile_lists_plain` on CPU tensors."""
    if rois.device.type == "cpu":
        return roi_tile_lists_plain(level_shapes, rois, level_idx, output_size, sampling_ratio)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_tile_lists: unsupported device {rois.device}")
    _check_bwd_levels(level_shapes)
    rois = _bwd_rois(rois)
    _check_level_idx(level_idx, rois)
    b, r = rois.shape[:2]
    _, pyr = _grad_pyramid(level_shapes, b, 0, torch.float32, rois.device, TILE)
    lists = torch.empty((b, pyr.tile_start[pyr.num_levels], -(-r // 32)), dtype=torch.int32,
                        device=rois.device)
    fn = _bwd_entry("roi_tile_lists",
                    (_GradPyramid, *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 4, ctypes.c_void_p))
    rc = fn(pyr, rois.data_ptr(), level_idx.data_ptr(), lists.data_ptr(), b, r, output_size,
            sampling_ratio, _build.stream_ptr(rois.device))
    _build.check("roi_align_bwd", rc, "roi_tile_lists")
    return lists


def multilevel_roi_align_bwd_cuda(
    level_shapes: dict[int, tuple[int, int]],
    dtype: torch.dtype,
    rois: torch.Tensor,
    level_idx: torch.Tensor,
    g: torch.Tensor,
    sampling_ratio: int = 2,
) -> dict[int, torch.Tensor]:
    """Kernel B2 on CUDA tensors; the plain version on CPU tensors.

    level_shapes {level: (H_l, W_l)} of the forward's pyramid (consecutive
    levels), its dtype, rois (B, R, 4) f32, level_idx (B, R) int32 as the
    forward used it, g (B, R, S, S, C) in ``dtype`` -> {level: (B, H_l,
    W_l, C)} in ``dtype``.  One call launches the binning pass and the
    main kernel, and counts once."""
    if rois.device.type == "cpu":
        return multilevel_roi_align_bwd_plain(level_shapes, dtype, rois, level_idx, g,
                                              sampling_ratio)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align_bwd kernel: unsupported device {rois.device}")
    _check_bwd_levels(level_shapes)
    if dtype not in _DTYPES:
        raise TypeError(f"roi_align_bwd kernel takes float32 or bfloat16, got {dtype}")
    rois = _bwd_rois(rois)
    b, r = rois.shape[:2]
    if (g.dtype != dtype or g.dim() != 5 or g.shape[:2] != rois.shape[:2]
            or g.shape[2] != g.shape[3] or g.device != rois.device):
        raise ValueError(f"g must be (B, R, S, S, C) {dtype} on {rois.device}, "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}")
    g = g.contiguous()
    _check_level_idx(level_idx, rois)
    s, c = g.shape[2], g.shape[-1]
    # Eight channels a load: C a multiple of 8 and 16-byte aligned rows.
    vec = c % 8 == 0 and g.data_ptr() % 16 == 0
    groups = min(BWD_GROUPS, -(-c // 8))

    out, pyr = _grad_pyramid(level_shapes, b, c, dtype, rois.device, TILE)
    lists = torch.empty((b, pyr.tile_start[pyr.num_levels], -(-r // 32)), dtype=torch.int32,
                        device=rois.device)
    fn = _bwd_entry("roi_align_backward",
                    (_GradPyramid, *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 8, ctypes.c_void_p))
    rc = fn(pyr, rois.data_ptr(), level_idx.data_ptr(), g.data_ptr(), lists.data_ptr(), b, r, c,
            s, sampling_ratio, _DTYPES[dtype], groups, int(vec), _build.stream_ptr(rois.device))
    _build.check("roi_align_bwd", rc, "roi_align_backward")
    multilevel_roi_align_bwd_cuda.launches += 1
    return out


multilevel_roi_align_bwd_cuda.launches = 0

BWD_IMPLS = ("pallas", "xla")


class MultilevelRoiAlign(torch.autograd.Function):
    """ROIAlign whose forward is B1 and whose backward is B2 (``bwd_impl=
    "pallas"``) or autograd of the plain forward (``"xla"``, the JAX
    package's ``bwd_impl="xla"``).  The levels assigned in the forward
    are saved and handed to B2.  Rois get no gradient.  On CPU tensors
    both kernels are their plain versions."""

    @staticmethod
    def forward(ctx, rois, levels, output_size, sampling_ratio, bwd_impl, *feats):
        pyramid = dict(zip(levels, feats))
        level_idx = roi_level_index(rois, levels)
        out = multilevel_roi_align_cuda(pyramid, rois, output_size, sampling_ratio,
                                        level_idx=level_idx)
        ctx.levels, ctx.sampling_ratio, ctx.bwd_impl = levels, sampling_ratio, bwd_impl
        ctx.output_size = output_size
        ctx.shapes = {l: tuple(f.shape[1:3]) for l, f in pyramid.items()}
        ctx.dtype = feats[0].dtype
        if bwd_impl == "xla":
            ctx.save_for_backward(rois, *feats)
        else:
            ctx.save_for_backward(rois, level_idx)
        return out

    @staticmethod
    def backward(ctx, g):
        rois = ctx.saved_tensors[0]
        if ctx.bwd_impl == "xla":
            feats = [f.detach().requires_grad_() for f in ctx.saved_tensors[1:]]
            with torch.enable_grad():
                out = multilevel_roi_align_plain(dict(zip(ctx.levels, feats)), rois,
                                                 ctx.output_size, ctx.sampling_ratio)
                grads = torch.autograd.grad(out, feats, g)
        else:
            by_level = multilevel_roi_align_bwd_cuda(
                ctx.shapes, ctx.dtype, rois, ctx.saved_tensors[1], g.to(ctx.dtype),
                ctx.sampling_ratio)
            grads = [by_level[l] for l in ctx.levels]
        d_rois = torch.zeros_like(rois) if ctx.needs_input_grad[0] else None
        return (d_rois, None, None, None, None, *grads)


def multilevel_roi_align_fast(
    feature_pyramid: dict[int, torch.Tensor],
    rois: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
    bwd_impl: str = "pallas",
) -> torch.Tensor:
    """:class:`MultilevelRoiAlign` over a pyramid dict (the JAX package's
    ``custom_vjp`` of the same name); with grad mode off (serving), B1
    alone, without the ``Function``."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"roi_align_bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    if not torch.is_grad_enabled():
        return multilevel_roi_align_cuda(feature_pyramid, rois, output_size, sampling_ratio)
    levels = sorted(feature_pyramid)
    return MultilevelRoiAlign.apply(rois, levels, output_size, sampling_ratio, bwd_impl,
                                    *(feature_pyramid[l] for l in levels))
