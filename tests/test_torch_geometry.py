"""Box geometry and anchors: the port against ``mx_rcnn_tpu.geometry``.

Bitwise in float32: snap (half to even, pinned), IoU, clip, the min-size
mask and the anchor grids.  ``decode_boxes`` calls ``exp``, and XLA:CPU's
``exp`` and torch's differ in the last bit on a fraction of inputs, so raw
decoded boxes are held within 2 ulp of each box's largest coordinate; with the exponent's argument at zero
(exp exact) and after the proposal path's 1/256-px snap they are bitwise.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu import geometry as G
from mx_rcnn_tpu_torch import geometry as T

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)


def _boxes(rng, n, canvas=500.0):
    xy = rng.uniform(-20, canvas, (n, 2))
    wh = rng.uniform(0, 150, (n, 2))
    wh[::9] = 0.0  # degenerate boxes
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_snap_rounds_half_to_even_pinned():
    # 2.5 and 3.5 grid units: half to even gives 2 and 4 (roundf would give 3, 4).
    x = np.array([2.5, 3.5, -2.5, 0.5, 1.5], np.float32) / 65536.0
    x = np.concatenate([x, [np.inf, -np.inf, 1e-3, 0.7]]).astype(np.float32)
    expect = np.array([2, 4, -2, 0, 2], np.float32) / 65536.0
    got = T.snap(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:5], expect)
    _eq(T.snap(torch.from_numpy(x)), G.snap(jnp.asarray(x)))
    _eq(T.snap(torch.from_numpy(x), bits=8), G.snap(jnp.asarray(x), bits=8))


def test_snap_bitwise_on_random_values():
    x = np.random.RandomState(0).uniform(-1000, 1000, 100_000).astype(np.float32)
    for bits in (8, 16):
        _eq(T.snap(torch.from_numpy(x), bits), G.snap(jnp.asarray(x), bits))


def test_iou_area_and_valid_mask_bitwise():
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 300), _boxes(rng, 200)
    _eq(T.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)),
        G.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    _eq(T.area(torch.from_numpy(a)), G.area(jnp.asarray(a)))
    for min_size in (0.0, 16.0):
        _eq(T.valid_box_mask(torch.from_numpy(a), min_size),
            G.valid_box_mask(jnp.asarray(a), min_size))


def test_clip_bitwise_with_per_image_sizes():
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 2 * 50, canvas=700).reshape(2, 50, 4)
    hw = np.array([[480.0, 640.0], [333.0, 500.0]], np.float32)
    got = T.clip_boxes(torch.from_numpy(boxes), torch.from_numpy(hw[:, :1]),
                       torch.from_numpy(hw[:, 1:]))
    for i in range(2):
        want = G.clip_boxes(jnp.asarray(boxes[i]), hw[i, 0], hw[i, 1])
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_decode_within_two_ulp_and_bitwise_at_zero_exponent(weights):
    rng = np.random.RandomState(3)
    anchors = _boxes(rng, 2000) + np.float32(1.0)
    deltas = (rng.randn(2000, 4) * 0.5).astype(np.float32)
    deltas[:5, 2:] = 9.0  # past BBOX_XFORM_CLIP
    got = T.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors), weights).numpy()
    want = np.asarray(G.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors), weights))
    # x1 = cx - w/2 can cancel: count ulps at the box's largest coordinate.
    ulp = np.spacing(np.abs(want).max(axis=1, keepdims=True).astype(np.float32))
    assert np.all(np.abs(got - want) <= 2 * ulp)
    flat = deltas.copy()
    flat[:, 2:] = 0.0
    _eq(T.decode_boxes(torch.from_numpy(flat), torch.from_numpy(anchors), weights),
        G.decode_boxes(jnp.asarray(flat), jnp.asarray(anchors), weights))


def test_decode_clip_snap_chain_bitwise():
    """The proposal path's chain: the 1/256-px snap absorbs exp's ulps."""
    rng = np.random.RandomState(4)
    anchors = _boxes(rng, 3000) + np.float32(1.0)
    deltas = (rng.randn(3000, 4) * 0.2).astype(np.float32)

    def chain(mod, to, d, a):
        return mod.snap(mod.clip_boxes(mod.decode_boxes(to(d), to(a)), 480.0, 640.0), bits=8)

    _eq(chain(T, torch.from_numpy, deltas, anchors), chain(G, jnp.asarray, deltas, anchors))


@pytest.mark.parametrize("stride,h,w", [(4, 13, 21), (16, 50, 84), (64, 3, 5)])
def test_anchor_grids_bitwise_in_hwa_order(stride, h, w):
    for scales in ((8.0,), (8.0, 16.0, 32.0)):
        jb = G.generate_base_anchors(stride, (0.5, 1.0, 2.0), scales)
        tb = T.generate_base_anchors(stride, (0.5, 1.0, 2.0), scales)
        np.testing.assert_array_equal(tb, jb)
        ja = G.shifted_anchors_np(jb, stride, h, w)
        ta = T.shifted_anchors_np(tb, stride, h, w)
        np.testing.assert_array_equal(ta, ja)
        assert ta.dtype == np.float32 and ta.shape == (h * w * len(scales) * 3, 4)
        # (H, W, A) row-major: row r of the grid, column c, anchor a.
        k = len(scales) * 3
        np.testing.assert_array_equal(
            ta.reshape(h, w, k, 4)[2 % h, 3 % w, 1], tb[1] + stride * np.array(
                [3 % w, 2 % h, 3 % w, 2 % h], np.float32)
        )
