"""Backbone + FPN + RPN head + box head on ``tiny_synthetic`` (float32): the
port against the flax detector with the same weights carried across by
the bridge.  The JAX package runs its exact TPU layout rewrites (s2d stem,
pool fold, C2 padding, packed RPN head) and the port the canonical forms,
so convolution sums differ in order: per-level features and head outputs
are held to a relative tolerance of 1e-4 of each tensor's largest
magnitude.  The (H, W, A) flattening of the RPN outputs and the HWC
flattening into ``fc6`` are asserted directly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)

RTOL = 1e-4  # of each tensor's max |value|: f32 conv sums in another order


@pytest.fixture(scope="module")
def models():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny_synthetic").model
    sd = init_variables(cfg, torch.Generator().manual_seed(0))
    port = TwoStageDetector(cfg, device="cpu")
    port.load_state_dict(sd)
    port.eval()
    return port, JaxDetector(cfg=jax_get_config("tiny_synthetic").model), to_jax_variables(sd)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def test_features_rpn_and_box_head_match_flax(models):
    port, jmodel, variables = models
    rng = np.random.RandomState(0)
    images = rng.randn(2, 128, 128, 3).astype(np.float32)
    with torch.no_grad():
        feats = port.features(torch.from_numpy(images))
        rpn = port.rpn(feats)
    jfeats = jmodel.apply(variables, jnp.asarray(images), method="features")
    assert sorted(feats) == sorted(jfeats) == [2, 3, 4, 5, 6]
    for lvl in feats:
        _close(feats[lvl].numpy(), jfeats[lvl])
    jrpn = jmodel.apply(variables, jfeats, method="rpn")
    for lvl in rpn:
        _close(rpn[lvl][0].numpy(), jrpn[lvl][0])
        _close(rpn[lvl][1].numpy(), jrpn[lvl][1])

    pooled = rng.randn(6, 7, 7, 256).astype(np.float32)
    with torch.no_grad():
        logits, deltas = port.box(torch.from_numpy(pooled))
    jl, jd = jmodel.apply(variables, jnp.asarray(pooled), method="box")
    assert logits.shape == (6, 5) and deltas.shape == (6, 5, 4)
    _close(logits.numpy(), jl)
    _close(deltas.numpy(), jd)


def test_rpn_outputs_flatten_in_hwa_order(models):
    port = models[0]
    x = torch.randn(1, 256, 5, 7)
    with torch.no_grad():
        logits, deltas = port.rpn_head(x)
        y = torch.relu(port.rpn_head.conv(x))
        obj = port.rpn_head.objectness(y)          # (1, A, H, W)
        reg = port.rpn_head.deltas(y)              # (1, 4A, H, W)
    a = obj.shape[1]
    assert logits.shape == (1, 5 * 7 * a) and deltas.shape == (1, 5 * 7 * a, 4)
    # Row r, column c, anchor k is flat index (r * W + c) * A + k.
    r, c, k = 3, 6, 2
    assert logits[0, (r * 7 + c) * a + k] == obj[0, k, r, c]
    np.testing.assert_array_equal(deltas[0, (r * 7 + c) * a + k].numpy(),
                                  reg[0, 4 * k:4 * k + 4, r, c].numpy())


def test_fc6_reads_pooled_features_in_hwc_order(models):
    port = models[0]
    pooled = torch.zeros(1, 7, 7, 256)
    y, x, ch = 2, 3, 5
    pooled[0, y, x, ch] = 1.0
    fc6 = port.box_head.fc6
    with torch.no_grad():
        out = fc6(pooled.reshape(1, -1))
        want = fc6.weight[:, (y * 7 + x) * 256 + ch] + fc6.bias
    np.testing.assert_array_equal(out[0].numpy(), want.numpy())
