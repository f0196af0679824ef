"""The fused proposal middle and FPN proposal generation: the port against
``mx_rcnn_tpu.ops.pallas.middle.fused_middle_levels`` in interpret mode
(L = 3 levels, k <= 128: the interpret-mode NMS loop is slow) and against
``generate_fpn_proposals`` on all three middles.  Candidates carry
snapped-score ties and ``-inf`` pad lanes.

Inside the interpret-mode kernel XLA:CPU contracts ``d * w + c`` into an
FMA, and its ``exp`` differs from torch's in the last bit on some inputs;
a coordinate within that bit of a 1/256-px rounding midpoint then snaps
one grid step apart.  So the fused-middle tests are bitwise on inputs
whose decode is exact in both (anchors on a 1/4-px grid, centre deltas on
a 1/16 grid, size deltas 0), and within one grid step on random deltas.
The FPN test runs the JAX chain op by op (no contraction), and its seeded
inputs put no coordinate on a midpoint: it is bitwise."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.geometry import snap
from mx_rcnn_tpu.ops.pallas.middle import fused_middle_levels as jax_middle
from mx_rcnn_tpu.ops.proposals import generate_fpn_proposals as jax_fpn
from mx_rcnn_tpu_torch.ops.cuda.middle import fused_middle_levels, fused_middle_levels_plain
from mx_rcnn_tpu_torch.ops.proposals import generate_fpn_proposals

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)


def _anchors(rng, n, canvas=400):
    a = rng.uniform(-30, canvas + 30, (n, 4)).astype(np.float32)
    lo, hi = np.minimum(a[:, :2], a[:, 2:]), np.maximum(a[:, :2], a[:, 2:]) + 1.0
    return np.concatenate([lo, hi], 1)


def _tied_sorted_scores(rng, n):
    """Top-k ordered scores: descending, heavy ties, -inf tail."""
    s = np.asarray(snap(jnp.asarray(np.round(rng.rand(n) * 12) / 12, jnp.float32)))
    s = -np.sort(-s, kind="stable")
    s[n - n // 5:] = -np.inf
    return s.astype(np.float32)


def _candidates(seed, levels=3, k=128, exact_decode=True):
    rng = np.random.RandomState(seed)
    an = np.stack([_anchors(rng, k) for _ in range(levels)])
    dl = (rng.randn(levels, k, 4) * 0.3).astype(np.float32)
    if exact_decode:  # every product and exp exact: no FMA or exp ulp can show
        an = np.round(an * 4) / 4
        dl = np.round(dl * 16) / 16
        dl[..., 2:] = 0.0
    sc = np.stack([_tied_sorted_scores(rng, k) for _ in range(levels)])
    return an, dl, sc


def _both(an, dl, sc, hw, min_size, thresh):
    want = jax_middle(jnp.asarray(an), jnp.asarray(dl), jnp.asarray(sc), *hw,
                      min_size=min_size, iou_threshold=thresh, interpret=True)
    image_hw = torch.tensor([hw], dtype=torch.float32)
    got = fused_middle_levels(torch.from_numpy(an)[None], torch.from_numpy(dl)[None],
                              torch.from_numpy(sc)[None], image_hw, min_size, thresh)
    return [g[0].numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("min_size,thresh", [(0.0, 0.7), (12.0, 0.5)])
def test_fused_middle_matches_pallas_interpret(min_size, thresh):
    an, dl, sc = _candidates(int(min_size), levels=3, k=128)
    got, want = _both(an, dl, sc, (300.0, 380.0), min_size, thresh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].any() and not got[2].all()


def test_fused_middle_random_size_deltas_within_one_grid_step():
    an, dl, sc = _candidates(0, levels=3, k=128, exact_decode=False)
    got, want = _both(an, dl, sc, (300.0, 380.0), 0.0, 0.7)
    assert np.abs(got[0] - want[0]).max() <= 1.0 / 256
    assert np.mean(got[0] == want[0]) > 0.99


def test_fused_middle_plain_batched_images_differ_by_size():
    an, dl, sc = _candidates(3, levels=2, k=64)
    t = [torch.from_numpy(np.stack([x, x])) for x in (an, dl, sc)]
    image_hw = torch.tensor([[300.0, 380.0], [120.0, 200.0]])
    boxes, masked, keep = fused_middle_levels_plain(*t, image_hw)
    for i, hw in enumerate(((300.0, 380.0), (120.0, 200.0))):
        want = jax_middle(jnp.asarray(an), jnp.asarray(dl), jnp.asarray(sc), *hw,
                          interpret=True)
        for g, w in zip((boxes[i], masked[i], keep[i]), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _fpn_inputs(seed):
    rng = np.random.RandomState(seed)
    scores, deltas, anchors = {}, {}, {}
    for lvl, n in ((2, 1500), (3, 400), (4, 100), (5, 40), (6, 12)):
        s = np.round(rng.rand(2, n) * 16) / 16
        s[:, ::7] = 0.0
        scores[lvl] = s.astype(np.float32)
        deltas[lvl] = (rng.randn(2, n, 4) * 0.2).astype(np.float32)
        anchors[lvl] = _anchors(rng, n)
    return scores, deltas, anchors


@pytest.mark.parametrize("branch", ["dense", "pallas-nms", "fused"])
def test_fpn_proposals_match_jax(branch):
    scores, deltas, anchors = _fpn_inputs(11)
    hw = np.array([[350.0, 420.0], [240.0, 300.0]], np.float32)
    kw = dict(pre_nms_top_n=120, post_nms_top_n=64, nms_threshold=0.7, min_size=0.0)
    got = generate_fpn_proposals(
        {l: torch.from_numpy(v) for l, v in scores.items()},
        {l: torch.from_numpy(v) for l, v in deltas.items()},
        {l: torch.from_numpy(v) for l, v in anchors.items()},
        torch.from_numpy(hw), **kw,
        nms_impl="pallas" if branch == "pallas-nms" else "xla",
        fused_middle=branch == "fused",
    )
    for i in range(2):
        want = jax_fpn(
            {l: jnp.asarray(v[i]) for l, v in scores.items()},
            {l: jnp.asarray(v[i]) for l, v in deltas.items()},
            {l: jnp.asarray(v) for l, v in anchors.items()},
            hw[i, 0], hw[i, 1], **kw,
        )  # the dense XLA oracle: every branch equals it bitwise
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got.valid.sum() > 0


def test_pallas_nms_branch_is_one_stacked_call(monkeypatch):
    """The pallas-nms branch runs the NMS kernel once a call over every
    (image, level) problem; its keep masks equal the per-level calls' (the
    JAX package's form, which pads short levels with -inf), and its
    proposals equal the JAX package's pallas-nms branch in interpret mode."""
    import mx_rcnn_tpu_torch.ops.cuda.nms as cuda_nms
    from mx_rcnn_tpu_torch.ops.nms import nms_indices
    from mx_rcnn_tpu_torch.ops.proposals import _pre_nms_candidates, _stack_padded

    scores, deltas, anchors = _fpn_inputs(12)
    hw = np.array([[350.0, 420.0], [240.0, 300.0]], np.float32)
    kw = dict(pre_nms_top_n=120, post_nms_top_n=64, nms_threshold=0.7, min_size=4.0)
    ts = {l: torch.from_numpy(v) for l, v in scores.items()}
    td = {l: torch.from_numpy(v) for l, v in deltas.items()}
    ta = {l: torch.from_numpy(v) for l, v in anchors.items()}
    image_hw = torch.from_numpy(hw)

    calls = []
    plain = cuda_nms.nms_keep_sorted_cuda
    monkeypatch.setattr(cuda_nms, "nms_keep_sorted_cuda",
                        lambda b, v, t: calls.append(tuple(b.shape)) or plain(b, v, t))
    got = generate_fpn_proposals(ts, td, ta, image_hw, **kw, nms_impl="pallas")
    assert calls == [(2, 5, 120, 4)]  # one call; the 40- and 12-box levels padded

    cand = [_pre_nms_candidates(ts[l], td[l], ta[l], image_hw, kw["pre_nms_top_n"],
                                kw["min_size"]) for l in sorted(ts)]
    bx = _stack_padded([b for b, _ in cand], 0.0)
    sc = _stack_padded([s for _, s in cand], -torch.inf)
    stacked = nms_indices(bx, sc, kw["nms_threshold"], kw["post_nms_top_n"], nms_impl="pallas")
    for lv in range(bx.shape[1]):
        one = nms_indices(bx[:, lv], sc[:, lv], kw["nms_threshold"], kw["post_nms_top_n"],
                          nms_impl="pallas")
        for a, b in zip(stacked, one):
            assert torch.equal(a[:, lv], b)

    for i in range(2):
        want = jax_fpn(
            {l: jnp.asarray(v[i]) for l, v in scores.items()},
            {l: jnp.asarray(v[i]) for l, v in deltas.items()},
            {l: jnp.asarray(v) for l, v in anchors.items()},
            hw[i, 0], hw[i, 1], **kw, nms_impl="pallas", pallas_interpret=True,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got.valid.sum() > 0
