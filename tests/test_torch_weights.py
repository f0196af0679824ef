"""The weight bridge on ``tiny_synthetic``: a flax variables tree (the JAX
detector's own structure, from ``jax.eval_shape`` of its ``init``) maps
leaf for leaf onto the port's ``state_dict`` with none left over or
missing, loads strictly, and comes back bitwise; ``init_variables`` draws
the flax initializers' distributions."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.weights import from_jax_variables, init_variables, to_jax_variables

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX detector's variables tree, seeded values at flax's shapes."""
    cfg = jax_get_config("tiny_synthetic")
    shapes = jax.eval_shape(JaxDetector(cfg=cfg.model).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *cfg.data.image_size, 3)))
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_every_leaf_maps_and_loads_strictly(jax_tree):
    sd = from_jax_variables(jax_tree)
    assert len(sd) == len(_leaves(jax_tree))
    model = TwoStageDetector(get_config("tiny_synthetic").model, device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert set(sd) == set(model.state_dict())


def test_layouts_are_transposed(jax_tree):
    sd = from_jax_variables(jax_tree)
    k = jax_tree["params"]["backbone"]["layer1_block0"]["conv2"]["kernel"]   # HWIO
    np.testing.assert_array_equal(sd["backbone.layer1_block0.conv2.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = jax_tree["params"]["box_head"]["fc6"]["kernel"]                      # (in, out)
    np.testing.assert_array_equal(sd["box_head.fc6.weight"].numpy(), d.T)
    np.testing.assert_array_equal(sd["rpn_head.objectness.bias"].numpy(),
                                  jax_tree["params"]["rpn"]["objectness"]["bias"])
    np.testing.assert_array_equal(sd["backbone.bn1.var"].numpy(),
                                  jax_tree["constants"]["backbone"]["bn1"]["var"])


def test_round_trip_is_bitwise(jax_tree):
    model = TwoStageDetector(get_config("tiny_synthetic").model, device="cpu")
    model.load_state_dict(from_jax_variables(jax_tree))
    back = _leaves(to_jax_variables(model.state_dict()))
    want = _leaves(jax_tree)
    assert set(back) == set(want)
    for key, value in want.items():
        assert back[key].dtype == value.dtype and back[key].shape == value.shape, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_init_variables_matches_flax_initializers(jax_tree):
    cfg = get_config("tiny_synthetic").model
    sd = init_variables(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in from_jax_variables(jax_tree).items()}
    again = init_variables(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    # lecun_normal: std 1/sqrt(fan_in), truncated at 2 std of the pre-scale.
    w = sd["backbone.layer3_block0.conv2.weight"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert abs(sd["rpn_head.conv.weight"].std().item() - 0.01) < 0.001
    assert abs(sd["box_head.bbox_pred.weight"].std().item() - 0.001) < 0.0002
    assert not sd["fpn.output3.bias"].any() and bool((sd["backbone.bn1.scale"] == 1).all())
