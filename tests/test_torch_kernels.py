"""The port's CUDA kernels against their plain torch versions on the card,
at small shapes.  Marked ``gpu``; each test takes the ``cuda`` fixture,
which skips when no card is present (decided when the test runs, never at
import, so every worker collects the same tests).  On the card:

    python -m pytest tests/test_torch_kernels.py -m gpu

B3 (fused middle) and B4 (NMS) are bitwise, both up to 2000 candidates
and over several problems in one call, B3's suppression words equal to
the plain ``suppression_words_plain`` on the tiles it writes; B2's
binning pass gives exactly the plain ``roi_tile_lists_plain`` bitsets;
B1 (ROIAlign) is bitwise in float32 and within one bf16 ulp in bfloat16
(it sums in the plain version's order, and the build keeps multiplies
and adds apart), at channel counts on both its paths (8 channels a
thread, one for the tail), on edge rois, at other sampling ratios, and
with the same bits from two launches.  B2
(ROIAlign backward) sums in another order than the plain ``index_add_``:
float32 within 1e-5 of the largest gradient of ``|g|`` (the sum of the
absolute contributions), bfloat16 within one bf16 ulp of the plain
version's float32 sum plus that; two launches are bitwise equal.  The
C4 shapes: B1 and B2 on one stride-16 level at C = 512 and 1024 (B1
bitwise to the single-level ``roi_align`` in float32), B3 at L = 1 and
B4 on one level at 6000 candidates.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mx_rcnn_tpu_torch.geometry import snap
from mx_rcnn_tpu_torch.ops.cuda.middle import (
    MAX_CANDIDATES,
    fused_middle_levels,
    _launch,
    fused_middle_levels_plain,
    suppression_words_plain,
)
from mx_rcnn_tpu_torch.ops.cuda.nms import (
    nms_keep_sorted_cuda,
    nms_keep_sorted_plain,
    nms_mask_cuda,
)
from mx_rcnn_tpu_torch.ops.cuda.roi_align import (
    multilevel_roi_align_bwd_cuda,
    multilevel_roi_align_bwd_plain,
    multilevel_roi_align_cuda,
    multilevel_roi_align_fast,
    multilevel_roi_align_plain,
    roi_level_index,
    roi_tile_lists_cuda,
    roi_tile_lists_plain,
)
from mx_rcnn_tpu_torch.ops.nms import nms_mask
from mx_rcnn_tpu_torch.ops.topk import top_k

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _boxes(rng, shape, canvas=400.0):
    xy = rng.uniform(0, canvas, (*shape, 2))
    wh = rng.uniform(4, 90, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 700])
def test_nms_kernel_bitwise(cuda, n):
    rng = np.random.RandomState(n)
    b = torch.tensor(_boxes(rng, (3, n)), device=cuda)
    v = torch.tensor(rng.rand(3, n) > 0.1, device=cuda)
    before = nms_mask_cuda.launches
    got = nms_keep_sorted_cuda(b, v, 0.5)
    torch.cuda.synchronize()
    assert nms_mask_cuda.launches == before + 1
    assert torch.equal(got, nms_keep_sorted_plain(b, v, 0.5))
    s = torch.tensor(np.round(rng.rand(3, n) * 8) / 8, dtype=torch.float32, device=cuda)
    assert torch.equal(nms_mask_cuda(b, s, 0.6, v), nms_mask(b, s, 0.6, v))


def _nms_case(rng, problems, n):
    """Sorted boxes and valid flags with an all-invalid problem, a run of
    identical boxes and a long nested chain: box k of the chain suppresses
    k + 1 (IoU 0.6) but not k + 2 (IoU 1/3), so greedy keeps every other."""
    boxes = _boxes(rng, (problems, n))
    valid = rng.rand(problems, n) > 0.1
    if problems > 1:
        valid[1] = False
    if n > 16:
        boxes[:, 6:16] = boxes[:, 5:6]
    if n > 40:
        k = np.arange(min(n - 20, 600))
        chain = np.stack([500 + 5.0 * k, 0 * k + 500, 520 + 5.0 * k, 0 * k + 520], -1)
        boxes[:, 20:20 + len(k)] = chain
        valid[0, 20:20 + len(k)] = True
    return (torch.tensor(boxes, device="cuda"), torch.tensor(valid, device="cuda"))


@pytest.mark.parametrize("problems", [1, 10])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 700, 1000, 2000])
def test_nms_kernel_bitwise_cases(cuda, n, problems):
    b, v = _nms_case(np.random.RandomState(n + problems), problems, n)
    before = nms_mask_cuda.launches
    got = nms_keep_sorted_cuda(b, v, 0.5)
    torch.cuda.synchronize()
    assert nms_mask_cuda.launches == before + 1
    want = nms_keep_sorted_plain(b, v, 0.5)
    assert torch.equal(got, want)
    if problems > 1:
        assert not got[1].any()
    if n > 40:
        assert bool(want[0, 20:60:2].all()) and not bool(want[0, 21:60:2].any())


@pytest.mark.parametrize("k,min_size", [(16, 0.0), (300, 0.0), (1000, 8.0)])
def test_fused_middle_kernel_bitwise(cuda, k, min_size):
    rng = np.random.RandomState(k)
    B, L, A = 2, 3, max(k, 1200)
    anchors = torch.tensor(_boxes(rng, (B, L, A)), device=cuda)
    deltas = torch.tensor(rng.randn(B, L, A, 4) * 0.3, dtype=torch.float32, device=cuda)
    scores = snap(torch.tensor(np.round(rng.rand(B, L, A) * 20) / 20, dtype=torch.float32,
                               device=cuda))
    ts, ti = top_k(scores, k)
    idx = ti[..., None].expand(B, L, k, 4)
    an, dl = torch.gather(anchors, 2, idx), torch.gather(deltas, 2, idx)
    ts[:, -1, k // 2:] = -torch.inf
    hw = torch.tensor([[300.0, 420.0], [400.0, 250.0]], device=cuda)
    before = fused_middle_levels.launches
    got = fused_middle_levels(an, dl, ts, hw, min_size, 0.7)
    torch.cuda.synchronize()
    assert fused_middle_levels.launches == before + 1
    want = fused_middle_levels_plain(an, dl, ts, hw, min_size, 0.7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel(cuda, dtype):
    rng = np.random.RandomState(0)
    pyr = {l: torch.tensor(rng.randn(2, 320 >> l, 448 >> l, 96), device=cuda).to(dtype)
           for l in (2, 3, 4, 5)}
    xy = rng.uniform(-10, 440, (2, 150, 2))
    wh = rng.uniform(1, 300, (2, 150, 2))
    rois = torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32, device=cuda)
    before = multilevel_roi_align_cuda.launches
    got = multilevel_roi_align_cuda(pyr, rois, 7, 2)
    torch.cuda.synchronize()
    assert multilevel_roi_align_cuda.launches == before + 1 and got.dtype == dtype
    want = multilevel_roi_align_plain(pyr, rois, 7, 2).float()
    diff = (got.float() - want).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
        assert bool((diff <= ulp).all())


def _ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126))) - 7)


def _bwd_case(cuda, c, rois_per_image=150, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {l: (320 >> l, 448 >> l) for l in (2, 3, 4, 5)}
    xy = rng.uniform(-10, 440, (2, rois_per_image, 2))
    wh = rng.uniform(1, 300, (2, rois_per_image, 2))
    rois = torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.randn(2, rois_per_image, 7, 7, c), dtype=torch.float32, device=cuda)
    return shapes, rois, roi_level_index(rois, (2, 3, 4, 5)), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [96, 256])
def test_roi_align_bwd_kernel(cuda, dtype, c):
    shapes, rois, li, g = _bwd_case(cuda, c)
    g = g.to(dtype)
    before = multilevel_roi_align_bwd_cuda.launches
    got = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    again = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    torch.cuda.synchronize()
    assert multilevel_roi_align_bwd_cuda.launches == before + 2
    want = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float())
    scale = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float().abs())
    for l in shapes:
        assert got[l].dtype == dtype and got[l].shape == (2, *shapes[l], c)
        assert torch.equal(got[l], again[l])                      # deterministic
        diff = (got[l].float() - want[l]).abs()
        tol = 1e-5 * float(scale[l].max().clamp(min=1.0))
        if dtype == torch.bfloat16:
            tol = _ulp(want[l]) + tol
        assert bool((diff <= tol).all()), l


def _bwd_rois(kind, rng, rois_per_image=150):
    """Rois on a 320x448 canvas: all inside one 8x8 tile of P2 (crowded),
    across tile edges at every level's stride and across the level
    thresholds (straddle), or partly outside the map (outside)."""
    n = rois_per_image
    if kind == "crowded":
        xy = rng.uniform(34.0, 44.0, (2, n, 2))
        rois = np.concatenate([xy, xy + rng.uniform(2.0, 14.0, (2, n, 2))], -1)
    elif kind == "straddle":
        stride = rng.choice([4, 8, 16, 32], (2, n, 1)) * 8.0
        ctr = np.round(rng.uniform(0, 448, (2, n, 2)) / stride) * stride
        half = rng.choice([56.0, 112.0, 224.0, 448.0], (2, n, 1)) / 2 * rng.uniform(0.9, 1.1, (2, n, 2))
        rois = np.concatenate([ctr - half, ctr + half], -1)
    else:
        xy = rng.uniform(-150, 450, (2, n, 2))
        rois = np.concatenate([xy, xy + rng.uniform(20, 300, (2, n, 2))], -1)
    return torch.tensor(rois, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [96, 256])
@pytest.mark.parametrize("kind", ["crowded", "straddle", "outside"])
def test_roi_align_bwd_kernel_cases(cuda, kind, c, dtype):
    rng = np.random.RandomState(len(kind) + c)
    shapes = {l: (320 >> l, 448 >> l) for l in (2, 3, 4, 5)}
    rois = _bwd_rois(kind, rng)
    li = roi_level_index(rois, (2, 3, 4, 5))
    g = torch.tensor(rng.randn(2, rois.shape[1], 7, 7, c), dtype=torch.float32,
                     device=cuda).to(dtype)
    got = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    again = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    torch.cuda.synchronize()
    want = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float())
    scale = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float().abs())
    for l in shapes:
        assert torch.equal(got[l], again[l])                      # deterministic
        diff = (got[l].float() - want[l]).abs()
        tol = 1e-5 * float(scale[l].max().clamp(min=1.0))
        if dtype == torch.bfloat16:
            tol = _ulp(want[l]) + tol
        assert bool((diff <= tol).all()), l
    if kind == "crowded":
        assert float(want[2].abs().sum()) > 0 and all(
            float(want[l].abs().sum()) == 0 for l in (3, 4, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [35, 320])
def test_roi_align_bwd_kernel_odd_and_wide_channels(cuda, dtype, c):
    shapes, rois, li, g = _bwd_case(cuda, c, rois_per_image=40, seed=c)
    g = g.to(dtype)
    got = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    want = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float())
    scale = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float().abs())
    for l in shapes:
        diff = (got[l].float() - want[l]).abs()
        tol = 1e-5 * float(scale[l].max().clamp(min=1.0))
        if dtype == torch.bfloat16:
            tol = _ulp(want[l]) + tol
        assert bool((diff <= tol).all()), l


@pytest.mark.parametrize("kind", ["crowded", "straddle", "outside", "random"])
def test_roi_tile_lists_kernel_exact(cuda, kind):
    rng = np.random.RandomState(len(kind))
    shapes = {l: (320 >> l, 448 >> l) for l in (2, 3, 4, 5)}
    if kind == "random":
        _, rois, li, _ = _bwd_case(cuda, 8, rois_per_image=77, seed=5)
    else:
        rois = _bwd_rois(kind, rng, rois_per_image=77)
        li = roi_level_index(rois, (2, 3, 4, 5))
    got = roi_tile_lists_cuda(shapes, rois, li)
    torch.cuda.synchronize()
    assert torch.equal(got, roi_tile_lists_plain(shapes, rois, li))


def test_roi_align_function_gradient(cuda):
    """The Function's backward (B2) is the adjoint of its forward (B1):
    <B1(x), g> = <x, B2(g)>, and it matches autograd of the plain forward."""
    shapes, rois, _, g = _bwd_case(cuda, 32, rois_per_image=40, seed=1)
    rng = np.random.RandomState(2)
    pyr = {l: torch.tensor(rng.randn(2, h, w, 32), dtype=torch.float32, device=cuda)
           for l, (h, w) in shapes.items()}
    p = {l: f.clone().requires_grad_() for l, f in pyr.items()}
    out = multilevel_roi_align_fast(p, rois, 7, 2, "pallas")
    out.backward(g)
    lhs = float((out.detach().double() * g.double()).sum())
    rhs = sum(float((pyr[l].double() * p[l].grad.double()).sum()) for l in pyr)
    assert abs(lhs - rhs) <= 1e-5 * (abs(lhs) + 1.0)
    q = {l: f.clone().requires_grad_() for l, f in pyr.items()}
    multilevel_roi_align_plain(q, rois).backward(g)
    for l in pyr:
        assert (p[l].grad - q[l].grad).abs().max().item() <= 1e-5 * max(
            1.0, q[l].grad.abs().max().item())


def test_wrappers_refuse_bad_inputs(cuda):
    pyr = {l: torch.zeros(1, 64 >> l, 64 >> l, 8, device=cuda) for l in (2, 3, 4, 5)}
    rois = torch.zeros(1, 4, 4, device=cuda)
    with pytest.raises(TypeError):
        multilevel_roi_align_cuda({l: f.half() for l, f in pyr.items()}, rois)
    with pytest.raises(ValueError):
        multilevel_roi_align_cuda({**pyr, 2: pyr[2].permute(0, 2, 1, 3)}, rois)
    with pytest.raises(ValueError):
        multilevel_roi_align_cuda({**pyr, 2: pyr[2].cpu()}, rois)
    with pytest.raises(ValueError):
        nms_keep_sorted_cuda(torch.zeros(2, 5, 4, device=cuda),
                             torch.zeros(2, 6, dtype=torch.bool, device=cuda), 0.5)
    li = roi_level_index(rois, (2, 3, 4, 5))
    shapes = {l: tuple(f.shape[1:3]) for l, f in pyr.items()}
    with pytest.raises(TypeError):
        multilevel_roi_align_bwd_cuda(shapes, torch.float16, rois, li,
                                      torch.zeros(1, 4, 7, 7, 8, device=cuda).half())
    with pytest.raises(ValueError):
        multilevel_roi_align_bwd_cuda(shapes, torch.float32, rois, li.long(),
                                      torch.zeros(1, 4, 7, 7, 8, device=cuda))
    with pytest.raises(TypeError):
        fused_middle_levels(torch.zeros(1, 1, 4, 4, device=cuda, dtype=torch.float64),
                            torch.zeros(1, 1, 4, 4, device=cuda),
                            torch.zeros(1, 1, 4, device=cuda), torch.zeros(1, 2, device=cuda))


def _middle_case(rng, b, levels, k, all_inf_level=False):
    """Top-k ordered candidates (b, levels, k) on a 400 px canvas: tied
    snapped scores, a -inf tail on the last level, optionally a level of
    -inf only; and two image sizes."""
    a = max(k + 64, 2 * k)
    anchors = torch.tensor(_boxes(rng, (b, levels, a)), device="cuda")
    deltas = torch.tensor(rng.randn(b, levels, a, 4) * 0.3, dtype=torch.float32, device="cuda")
    scores = snap(torch.tensor(np.round(rng.rand(b, levels, a) * 20) / 20, dtype=torch.float32,
                               device="cuda"))
    ts, ti = top_k(scores, k)
    idx = ti[..., None].expand(b, levels, k, 4)
    an, dl = torch.gather(anchors, 2, idx), torch.gather(deltas, 2, idx)
    ts[:, -1, k - k // 4:] = -torch.inf
    if all_inf_level:
        ts[-1, 0] = -torch.inf
    hw = torch.tensor([[300.0, 420.0], [400.0, 250.0]][:b], device="cuda")
    return an, dl, ts, hw


@pytest.mark.parametrize("min_size", [0.0, 8.0])
@pytest.mark.parametrize("problems", [1, 10])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 127, 1000, 2000])
def test_fused_middle_kernel_bitwise_cases(cuda, k, problems, min_size):
    b, levels = (1, 1) if problems == 1 else (2, 5)
    an, dl, ts, hw = _middle_case(np.random.RandomState(k + problems), b, levels, k,
                                  all_inf_level=problems > 1)
    before = fused_middle_levels.launches
    boxes, masked, keep, words = _launch(an, dl, ts, hw, min_size, 0.7)  # the words too
    torch.cuda.synchronize()
    assert fused_middle_levels.launches == before + 1  # one call, two launches
    want = fused_middle_levels_plain(an, dl, ts, hw, min_size, 0.7)
    for g, w in zip((boxes, masked, keep), want):
        assert torch.equal(g, w)
    if problems > 1:
        assert not keep[-1, 0].any()
    # The words of the tiles at or above the diagonal are the plain ones.
    plain = suppression_words_plain(want[0], torch.isfinite(want[1]), 0.7)
    cb = plain.shape[-1]
    row_chunk = torch.arange(k, device=cuda) // 64
    written = torch.arange(cb, device=cuda)[None, :] >= row_chunk[:, None]
    assert torch.equal(torch.where(written, words, 0), plain)


def test_fused_middle_kernel_refuses_too_many_candidates(cuda):
    k = MAX_CANDIDATES + 1
    z = torch.zeros(1, 1, k, 4, device=cuda)
    with pytest.raises(ValueError):
        fused_middle_levels(z, z, torch.zeros(1, 1, k, device=cuda), torch.ones(1, 2, device=cuda))


def _pyramid(rng, c, dtype, canvas=(320, 448)):
    return {l: torch.tensor(rng.randn(2, canvas[0] >> l, canvas[1] >> l, c),
                            dtype=torch.float32, device="cuda").to(dtype) for l in (2, 3, 4, 5)}


def _random_rois(rng, n=150):
    xy = rng.uniform(-10, 440, (2, n, 2))
    wh = rng.uniform(1, 300, (2, n, 2))
    return torch.tensor(np.concatenate([xy, xy + wh], -1), dtype=torch.float32, device="cuda")


def _hold_fwd(pyr, rois, s=7, sr=2, **kw):
    """B1 against its plain version (bitwise-stable across launches, within
    tolerance of the plain sums); returns the kernel's output."""
    before = multilevel_roi_align_cuda.launches
    got = multilevel_roi_align_cuda(pyr, rois, s, sr, **kw)
    again = multilevel_roi_align_cuda(pyr, rois, s, sr, **kw)
    torch.cuda.synchronize()
    assert multilevel_roi_align_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = multilevel_roi_align_plain(pyr, rois, s, sr).float()
    diff = (got.float() - want).abs()
    if got.dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        assert bool((diff <= _ulp(want)).all())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [35, 96, 256, 320])
def test_roi_align_kernel_channels(cuda, c, dtype):
    rng = np.random.RandomState(c)
    _hold_fwd(_pyramid(rng, c, dtype), _random_rois(rng, 60))


@pytest.mark.parametrize("s,sr", [(7, 1), (7, 3), (14, 4)])
def test_roi_align_kernel_other_sampling_ratios(cuda, s, sr):
    """sampling_ratio != 2 takes the kernel's form with run-time sample
    loops; 14 x 4 fills the 56 of its 64 table entries an axis."""
    rng = np.random.RandomState(s + sr)
    _hold_fwd(_pyramid(rng, 64, torch.bfloat16), _random_rois(rng, 40), s, sr)


def _edge_rois(kind, rng, n=96):
    """Rois on a 320x448 canvas: wholly or partly outside it; degenerate
    (zero, inverted, under one cell); sized at the FPN level thresholds and
    the 38-cell extent bound, so that they straddle level borders; or all
    small, so that every roi pools from P2."""
    xy = rng.uniform(0, [448, 320], (2, n, 2))
    if kind == "outside":
        rois = np.concatenate([xy, xy + rng.uniform(5, 200, (2, n, 2))], -1)
        rois[:, ::2] += rng.choice([-800.0, 800.0], (2, n // 2, 1))
        rois[:, 1::4, :2] = -40.0
        rois[:, 3::4, 2:] = [470.0, 350.0]
    elif kind == "degenerate":
        rois = np.concatenate([xy, xy + rng.uniform(0, 0.9, (2, n, 2))], -1)
        rois[:, ::3, 2:] = rois[:, ::3, :2]
        rois[:, 1::3, 2:] = rois[:, 1::3, :2] - rng.uniform(1, 30, (2, len(range(1, n, 3)), 2))
    elif kind == "straddle":
        side = rng.choice([112.0, 224.0, 448.0, 38.0 * 4, 38.0 * 8], (2, n, 1))
        side = side * rng.uniform(0.98, 1.02, (2, n, 2))
        rois = np.concatenate([xy - side / 2, xy + side / 2], -1)
    else:
        rois = np.concatenate([xy, xy + rng.uniform(2, 100, (2, n, 2))], -1)
    return torch.tensor(rois, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["outside", "degenerate", "straddle", "one_level"])
def test_roi_align_kernel_edge_rois(cuda, kind, dtype):
    rng = np.random.RandomState(len(kind))
    rois = _edge_rois(kind, rng)
    levels = roi_level_index(rois, (2, 3, 4, 5))
    if kind == "one_level":
        assert not levels.any()
    if kind == "straddle":
        assert len(torch.unique(levels)) == 4
    got = _hold_fwd(_pyramid(rng, 64, dtype), rois)
    if kind == "outside":
        assert not got[:, ::2].any()  # wholly outside: every sample counts zero


# The single-level C4 recipe: one stride-16 map (C = 1024 for ResNet's
# C4, 512 for VGG's conv5_3) and rois as wide as its 128-512 px anchors
# and their ratios, up to the whole map.
def _c4_case(rng, c, rois_per_image=128, canvas=(608, 1024)):
    h, w = canvas
    feat = torch.tensor(rng.randn(2, h // 16, w // 16, c), dtype=torch.float32, device="cuda")
    ctr = rng.uniform(0, [w, h], (2, rois_per_image, 2))
    size = rng.uniform(16, 1.2 * w, (2, rois_per_image, 2))
    rois = np.concatenate([ctr - size / 2, ctr + size / 2], -1)
    rois[:, 0] = [0, 0, w, h]
    return feat, torch.tensor(rois, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [512, 1024])
def test_roi_align_kernel_one_level_c4(cuda, c, dtype):
    """B1 over the one-level pyramid {4: C4}: every roi on level 4 at scale
    1/16, which is the single-level ``roi_align`` of the C4 recipe; in
    float32 the kernel gives its bits exactly."""
    from mx_rcnn_tpu_torch.ops.roi_align import roi_align

    feat, rois = _c4_case(np.random.RandomState(c), c)
    feat = feat.to(dtype)
    assert not roi_level_index(rois, (4,)).any()
    got = _hold_fwd({4: feat}, rois)
    if dtype == torch.float32:
        assert torch.equal(got, roi_align(feat, rois, 7, 1.0 / 16, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [512, 1024])
def test_roi_align_bwd_kernel_one_level_c4(cuda, c, dtype):
    """B2 on one level at C4 shapes, 128 rois an image: most 8x8 tiles'
    lists hold most of the image's rois."""
    rng = np.random.RandomState(c + 1)
    feat, rois = _c4_case(rng, c)
    shapes = {4: tuple(feat.shape[1:3])}
    li = roi_level_index(rois, (4,))
    g = torch.tensor(rng.randn(2, rois.shape[1], 7, 7, c), dtype=torch.float32,
                     device=cuda).to(dtype)
    got = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    again = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    torch.cuda.synchronize()
    want = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float())
    scale = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float().abs())
    assert torch.equal(got[4], again[4]) and got[4].shape == (2, *shapes[4], c)
    diff = (got[4].float() - want[4]).abs()
    tol = 1e-5 * float(scale[4].max().clamp(min=1.0))
    if dtype == torch.bfloat16:
        tol = _ulp(want[4]) + tol
    assert bool((diff <= tol).all())


# Mask R-CNN's branch pools at 14x14 (28 samples an axis at sampling
# ratio 2): 100 detections an image when serving, the 128-roi fg prefix
# an image when training.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rois_per_image", [100, 128])
def test_roi_align_kernel_mask_14(cuda, rois_per_image, dtype):
    rng = np.random.RandomState(rois_per_image)
    got = _hold_fwd(_pyramid(rng, 256, dtype), _random_rois(rng, rois_per_image), 14, 2)
    assert got.shape == (2, rois_per_image, 14, 14, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "crowded", "straddle"])
def test_roi_align_bwd_kernel_mask_14(cuda, kind, dtype):
    rng = np.random.RandomState(len(kind) + 14)
    shapes = {l: (320 >> l, 448 >> l) for l in (2, 3, 4, 5)}
    if kind == "random":
        _, rois, _, _ = _bwd_case(cuda, 8, rois_per_image=128, seed=14)
    else:
        rois = _bwd_rois(kind, rng, rois_per_image=128)
    li = roi_level_index(rois, (2, 3, 4, 5))
    g = torch.tensor(rng.randn(2, 128, 14, 14, 256), dtype=torch.float32, device=cuda).to(dtype)
    got = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    again = multilevel_roi_align_bwd_cuda(shapes, dtype, rois, li, g)
    torch.cuda.synchronize()
    want = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float())
    scale = multilevel_roi_align_bwd_plain(shapes, torch.float32, rois, li, g.float().abs())
    for l in shapes:
        assert torch.equal(got[l], again[l])                      # deterministic
        diff = (got[l].float() - want[l]).abs()
        tol = 1e-5 * float(scale[l].max().clamp(min=1.0))
        if dtype == torch.bfloat16:
            tol = _ulp(want[l]) + tol
        assert bool((diff <= tol).all()), l


def test_roi_align_function_gradient_mask_14(cuda):
    """The autograd Function at output size 14: B1 forward, B2 backward,
    against autograd of the plain forward."""
    rng = np.random.RandomState(28)
    pyr = {l: t.requires_grad_() for l, t in _pyramid(rng, 64, torch.float32).items()}
    rois = _random_rois(rng, 50)
    out = multilevel_roi_align_fast(pyr, rois, 14, 2, "pallas")
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, list(pyr.values()), g)
    ref = {l: t.detach().clone().requires_grad_() for l, t in pyr.items()}
    want = torch.autograd.grad(multilevel_roi_align_plain(ref, rois, 14, 2), list(ref.values()), g)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * max(float(b.abs().max()), 1.0)


def test_fused_middle_kernel_one_level_k6000(cuda):
    """B3 at L = 1 and the C4 pre-NMS top-n, k = 6000: 94 chunk steps."""
    an, dl, ts, hw = _middle_case(np.random.RandomState(6000), 2, 1, 6000)
    got = fused_middle_levels(an, dl, ts, hw, 0.0, 0.7)
    want = fused_middle_levels_plain(an, dl, ts, hw, 0.0, 0.7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any() and not got[2].all()


def test_nms_kernel_one_level_n6000(cuda):
    """B4 on one level at the C4 pre-NMS top-n, n = 6000, two problems."""
    b, v = _nms_case(np.random.RandomState(6001), 2, 6000)
    got = nms_keep_sorted_cuda(b, v, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_keep_sorted_plain(b, v, 0.7))
    assert not got[1].any() and got[0].any()
