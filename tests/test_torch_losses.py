"""Detection losses: the port against the JAX package on the same inputs.

Elementwise smooth-L1 is bitwise.  Reductions sum in another order than
XLA:CPU, and ``log_softmax``/``log_sigmoid`` differ from XLA's in the last
bit, so every loss is held within float32 round-off: rtol 2e-6, atol 1e-7.
Accuracies are counts over a count and equal exactly.  The RPN losses in
their dense and compact forms agree with JAX's forms and with each other;
the R-CNN losses run per class and class-agnostic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.detection import graph as JG
from mx_rcnn_tpu.geometry import losses as JL
from mx_rcnn_tpu.ops.sampling import assign_anchors as jax_assign
from mx_rcnn_tpu.ops.sampling import sample_rois as jax_sample
from mx_rcnn_tpu_torch.detection import graph as TG
from mx_rcnn_tpu_torch.geometry import losses as TL
from mx_rcnn_tpu_torch.ops.sampling import AnchorTargets, RoiSamples

torch.set_num_threads(2)

TOL = dict(rtol=2e-6, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, shape, canvas=128.0, lo=6.0, hi=80.0):
    xy = rng.uniform(-4, canvas, (*shape, 2))
    wh = rng.uniform(lo, hi, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_elementwise_and_masked_losses_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(500) * 0.5).astype(np.float32)
    x[:4] = [1 / 9, -1 / 9, 1.0, 0.0]
    for sigma in (1.0, 3.0):
        np.testing.assert_array_equal(TL.smooth_l1(_t(x), sigma).numpy(),
                                      np.asarray(JL.smooth_l1(jnp.asarray(x), sigma)))
    pred, tgt = rng.randn(2, 60, 4).astype(np.float32)
    w = (rng.rand(60, 1) > 0.5).astype(np.float32)
    for norm in (0.0, 37.0):
        np.testing.assert_allclose(
            TL.weighted_smooth_l1(_t(pred), _t(tgt), _t(w), 3.0, norm).numpy(),
            np.asarray(JL.weighted_smooth_l1(jnp.asarray(pred), jnp.asarray(tgt),
                                             jnp.asarray(w), sigma=3.0, normalizer=norm)),
            **TOL)
    logits = (rng.randn(64, 81) * 3).astype(np.float32)
    labels = rng.randint(-1, 81, 64).astype(np.int32)
    valid = labels >= 0
    np.testing.assert_allclose(
        TL.masked_softmax_cross_entropy(_t(logits), _t(labels), _t(valid)).numpy(),
        np.asarray(JL.masked_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                   jnp.asarray(valid))), **TOL)


@pytest.fixture(scope="module")
def rpn_case():
    """JAX anchor targets over a 4092-anchor grid, carried to the port's
    type, and random head outputs in float32 and bfloat16."""
    rng = np.random.RandomState(1)
    from mx_rcnn_tpu_torch.config import get_config

    feats = {l: torch.empty(1, 128 >> l, 128 >> l, 1) for l in range(2, 7)}
    a = TG.level_anchors(get_config("tiny_synthetic").model, feats)
    anchors = jnp.asarray(torch.cat([a[l] for l in sorted(a)]).numpy())
    gt = jnp.asarray(_boxes(rng, (2, 8)))
    gv = jnp.asarray(np.array([[True] * 5 + [False] * 3, [True] * 2 + [False] * 6]))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jt = jax.vmap(lambda k, g, v: jax_assign(k, anchors, g, v, 128.0, 128.0, batch_size=64))(
        keys, gt, gv)
    tt = AnchorTargets(*(_t(x) for x in jt))
    n = anchors.shape[0]
    logits = (rng.randn(2, n) * 2).astype(np.float32)
    deltas = (rng.randn(2, n, 4) * 0.5).astype(np.float32)
    return jt, tt, logits, deltas


@pytest.mark.parametrize("impl", ["dense", "compact"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rpn_losses_match_jax(rpn_case, impl, dtype):
    jt, tt, logits, deltas = rpn_case
    jl, jd = jnp.asarray(logits).astype(dtype), jnp.asarray(deltas).astype(dtype)
    want = JG._rpn_losses(jl, jd, jt, impl)
    tdt = getattr(torch, dtype)
    got = TG._rpn_losses(_t(logits).to(tdt), _t(deltas).to(tdt), tt, impl)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert got[2].item() == float(want[2])              # accuracy: exact


def test_rpn_dense_and_compact_agree(rpn_case):
    _, tt, logits, deltas = rpn_case
    dense = TG._rpn_losses(_t(logits), _t(deltas), tt, "dense")
    compact = TG._rpn_losses(_t(logits), _t(deltas), tt, "compact")
    for d, c in zip(dense, compact):
        np.testing.assert_allclose(c.numpy(), d.numpy(), **TOL)
    assert dense[2].item() == compact[2].item()
    with pytest.raises(ValueError):
        TG._rpn_losses(_t(logits), _t(deltas), tt, "sparse")


@pytest.mark.parametrize("class_agnostic", [False, True])
def test_rcnn_losses_match_jax(class_agnostic):
    rng = np.random.RandomState(2)
    b, r, g, c = 2, 200, 8, 5
    gt = _boxes(rng, (b, g))
    gv = np.ones((b, g), bool)
    rois = np.concatenate([gt[:, rng.randint(0, g, r // 2)] + rng.normal(0, 3, (b, r // 2, 4)),
                           _boxes(rng, (b, r // 2))], 1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), b)
    js = jax.vmap(lambda k, ro, gb: jax_sample(
        k, ro, jnp.ones(r, bool), gb, jnp.asarray(rng.randint(1, c, g).astype(np.int32)),
        jnp.ones(g, bool), batch_size=32))(keys, jnp.asarray(rois), jnp.asarray(gt))
    ts = RoiSamples(*(_t(x) for x in js))
    n = b * 32
    logits = (rng.randn(n, c) * 2).astype(np.float32)
    deltas = rng.randn(n, 1 if class_agnostic else c, 4).astype(np.float32)
    want = JG._rcnn_losses(jnp.asarray(logits), jnp.asarray(deltas), js, class_agnostic)
    got = TG._rcnn_losses(_t(logits), _t(deltas), ts, class_agnostic)
    for gg, w in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), **TOL)
    assert got[2].item() == float(want[2])
    assert ts.fg_mask.sum() > 0
