"""Anchor assignment and roi sampling: the port against the JAX package on
the same inputs and the same draws.

The JAX functions draw their priorities from threefry keys; the port takes
the priorities as arguments, so each test draws them from the keys exactly
as the JAX code does (``split`` into the fg and bg keys, then ``uniform``)
and hands them to the port.

Tolerances: every discrete output (labels, masks, ``sel_*``, sampled rois,
labels, weights, ``gt_indices``) is bitwise, with and without
``gt_ignore``; ``bbox_targets`` are within 4 float32 ulp (rtol 5e-7, atol
1e-6), because XLA:CPU's ``log`` differs from torch's in the last bit on
some inputs.  IoU and IoA are bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.geometry import encode_boxes as jax_encode
from mx_rcnn_tpu.geometry import ioa_matrix as jax_ioa
from mx_rcnn_tpu.geometry import iou_matrix as jax_iou
from mx_rcnn_tpu.ops.sampling import assign_anchors as jax_assign
from mx_rcnn_tpu.ops.sampling import sample_rois as jax_sample
from mx_rcnn_tpu_torch.detection.graph import level_anchors
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.geometry import encode_boxes, ioa_matrix, iou_matrix
from mx_rcnn_tpu_torch.ops.sampling import assign_anchors, sample_rois

torch.set_num_threads(2)

TARGET_TOL = dict(rtol=5e-7, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, shape, canvas=128.0, lo=4.0, hi=70.0):
    xy = rng.uniform(-8, canvas, (*shape, 2))
    wh = rng.uniform(lo, hi, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _draws(keys, n):
    """The two uniforms each JAX sampler draws from its per-image key."""
    def one(k):
        k_fg, k_bg = jax.random.split(k)
        return jax.random.uniform(k_fg, (n,)), jax.random.uniform(k_bg, (n,))
    fg, bg = jax.vmap(one)(keys)
    return _t(fg), _t(bg)


@pytest.fixture(scope="module")
def anchors():
    cfg = get_config("tiny_synthetic").model
    feats = {l: torch.empty(1, 128 >> l, 128 >> l, 1) for l in range(2, 7)}
    a = level_anchors(cfg, feats)
    return torch.cat([a[l] for l in sorted(a)]).numpy()


def test_encode_ioa_iou_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, (300,)), _boxes(rng, (17,))
    a[:3] = [[5, 5, 5, 9], [0, 0, 0, 0], [10, 10, 8, 12]]       # zero and negative area
    np.testing.assert_array_equal(ioa_matrix(_t(a), _t(b)).numpy(),
                                  np.asarray(jax_ioa(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(iou_matrix(_t(a), _t(b)).numpy(),
                                  np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b))))
    g = _boxes(rng, (300,))
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        np.testing.assert_allclose(
            encode_boxes(_t(g), _t(a), w).numpy(),
            np.asarray(jax_encode(jnp.asarray(g), jnp.asarray(a), w)), **TARGET_TOL)


def _gt(rng, b=2, g=8, n_valid=(5, 0)):
    gt = _boxes(rng, (b, g), lo=10.0, hi=90.0)
    gv = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        gv[i, :n] = True
    return gt, gv


@pytest.mark.parametrize("with_ignore", [False, True])
@pytest.mark.parametrize("assign_block", [0, 1024])
def test_assign_anchors_bitwise(anchors, with_ignore, assign_block):
    rng = np.random.RandomState(1)
    b, a = 3, anchors.shape[0]
    gt, gv = _gt(rng, b, n_valid=(5, 0, 8))
    gt[0, 0] = [-3.0, 2.0, 40.0, 60.0]                 # crosses the border
    gi = None
    if with_ignore:
        gi = np.zeros_like(gv)
        gi[0, 5] = gi[2, 7] = True
        gv[2, 7] = False
        gt[0, 5] = [60.0, 60.0, 127.0, 127.0]
    hw = np.array([[128.0, 128.0], [100.0, 120.0], [128.0, 96.0]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    want = jax.vmap(
        lambda k, g_, v_, i_, h_: jax_assign(
            k, jnp.asarray(anchors), g_, v_, h_[0], h_[1], batch_size=64,
            gt_ignore=i_, assign_block=assign_block, topk_block=512),
        in_axes=(0, 0, 0, 0 if gi is not None else None, 0),
    )(keys, jnp.asarray(gt), jnp.asarray(gv), None if gi is None else jnp.asarray(gi),
      jnp.asarray(hw))
    fg_draw, bg_draw = _draws(keys, a)
    got = assign_anchors(_t(anchors), _t(gt), _t(gv), _t(hw), fg_draw, bg_draw,
                         batch_size=64, gt_ignore=None if gi is None else _t(gi))
    for name in ("labels", "fg_mask", "valid_mask", "sel_idx", "sel_take", "sel_fg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               **TARGET_TOL)
    labels = got.labels.numpy()
    assert (labels[0] == 1).sum() > 0 and (labels[0] == 0).sum() > 0
    assert (labels[1] == 1).sum() == 0                  # no gt: bg only
    assert got.sel_take.sum(1).tolist() == [64, 64, 64]


@pytest.mark.parametrize("with_ignore", [False, True])
def test_sample_rois_bitwise(with_ignore):
    """r50_fpn_coco's batch (512 rois, 0.25 fg) from 1000 proposals, with
    enough fg and bg candidates that the float32 priorities round in
    blocks and the sample order rests on the stable sort."""
    rng = np.random.RandomState(2)
    b, r, g = 2, 1000, 8
    gt, gv = _gt(rng, b, g, n_valid=(6, 3))
    # Proposals jittered around the gt (fg) and spread over the canvas (bg).
    near = gt[:, rng.randint(0, 3, r // 2)] + rng.normal(0, 4, (b, r // 2, 4)).astype(np.float32)
    rois = np.concatenate([near, _boxes(rng, (b, r - r // 2))], 1).astype(np.float32)
    rv = rng.rand(b, r) > 0.05
    cls = rng.randint(1, 5, (b, g)).astype(np.int32)
    gi = None
    if with_ignore:
        gi = np.zeros_like(gv)
        gi[1, 6] = True
        gt[1, 6] = [0.0, 0.0, 90.0, 90.0]
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    kw = dict(batch_size=512, fg_fraction=0.25)
    want = jax.vmap(
        lambda k, ro, v, gb, gc, gvv, gii: jax_sample(k, ro, v, gb, gc, gvv, gt_ignore=gii, **kw),
        in_axes=(0, 0, 0, 0, 0, 0, 0 if gi is not None else None),
    )(keys, jnp.asarray(rois), jnp.asarray(rv), jnp.asarray(gt), jnp.asarray(cls),
      jnp.asarray(gv), None if gi is None else jnp.asarray(gi))
    fg_draw, bg_draw = _draws(keys, r + g)
    got = sample_rois(_t(rois), _t(rv), _t(gt), _t(cls), _t(gv), fg_draw, bg_draw,
                      gt_ignore=None if gi is None else _t(gi), **kw)
    for name in ("rois", "labels", "label_weights", "fg_mask", "gt_indices"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               **TARGET_TOL)
    fg = got.fg_mask.numpy().sum(1)
    assert (fg > 64).all() and (fg <= 128).all()       # past one rounding block of 3e9
    assert (got.label_weights.numpy().sum(1) > fg + 64).all()


def test_sample_rois_pads_with_zero_weight():
    """Fewer candidates than the batch: zero-weight padding slots."""
    rng = np.random.RandomState(4)
    gt, gv = _gt(rng, 1, 8, n_valid=(2,))
    rois = _boxes(rng, (1, 10))
    rv = np.ones((1, 10), bool)
    fg_draw, bg_draw = (torch.rand(1, 18, generator=torch.Generator().manual_seed(s))
                        for s in (0, 1))
    got = sample_rois(_t(rois), _t(rv), _t(gt), _t(np.ones((1, 8), np.int32)), _t(gv),
                      fg_draw, bg_draw, batch_size=16)
    w = got.label_weights.numpy()[0]
    assert got.rois.shape == (1, 16, 4)
    assert w.sum() <= 12 and (w[int(w.sum()):] == 0).all()
    assert (got.labels.numpy()[0][w == 0] == 0).all()
