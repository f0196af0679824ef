"""The port's int8 serving quantization against the JAX package's, on
``tiny_synthetic`` (its mask head on, for the transposed convolution), same
weights carried by the bridge:

  * ``quantize_per_channel`` gives bitwise JAX's ``q`` and ``scale`` (and
    their dequantized product) after ``weights.py``'s layout conversion,
    for Dense, Conv2d and the mask head's ConvTranspose2d, a zero channel
    included, and ``quantize_network`` quantizes the weights JAX's does;
  * ``dequantize_network`` is exact: one f32 product of ``q`` and its
    channel scale, within scale / 2 of the master, biases and FrozenBN
    buffers untouched;
  * ``apply_box_head_q8`` agrees with JAX's on the same pooled features
    within 1e-4 of the largest output (both sum bf16 products in f32, in
    another order, and round fc7's input to bf16 from those sums; 5e-6 seen);
  * the ``full_q8`` and ``full_q8n`` forwards reproduce JAX's (jitted, as
    the JAX runner compiles them)
    ``forward_inference(..., box_head_apply=...)`` and
    ``forward_inference(model, dequantize_network(qn), ...)`` by
    ``match_fraction`` (same class, IoU >= 0.9, score within 1e-3) for at
    least 90% of the detections: the convolutions sum in another order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.detection import Batch as JaxBatch
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu.detection import graph as JG
from mx_rcnn_tpu.serve import quantize as JQ
from mx_rcnn_tpu.utils import precision as JP
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.detection import graph as TG
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction, unletterbox_detections
from mx_rcnn_tpu_torch.serve import quantize as TQ
from mx_rcnn_tpu_torch.serve.engine import _Bound
from mx_rcnn_tpu_torch.utils import precision as TP
from mx_rcnn_tpu_torch.weights import (
    from_jax_variables,
    init_variables,
    output_axis,
    to_jax_variables,
)

torch.set_num_threads(2)

MASK = ["model.mask.enabled=true", "model.mask.pooled_size=7", "model.mask.resolution=14"]
HW = np.array([[128.0, 128.0], [100.0, 120.0]], np.float32)


def _jax_cfg(over):
    from mx_rcnn_tpu.config import apply_overrides as jax_overrides

    return jax_overrides(jax_get_config("tiny_synthetic"), over)


@pytest.fixture(scope="module")
def weights():
    """A mask model's state_dict (the deconv included) with a zero output
    channel in a Dense, a Conv2d and the ConvTranspose2d, and its flax
    tree."""
    cfg = apply_overrides(get_config("tiny_synthetic"), MASK)
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    sd["box_head.fc7.weight"][3] = 0.0
    sd["backbone.conv1.weight"][5] = 0.0
    sd["mask_head.deconv.weight"][:, 2] = 0.0
    return sd, to_jax_variables(sd)


def _kernel_path(key):
    """A state_dict weight key -> its flax ``params`` path (weights.py)."""
    path = key.split(".")
    return [{"rpn_head": "rpn"}.get(path[0], path[0]), *path[1:-1], "kernel"]


def _as_port(key, leaf):
    """One flax kernel-shaped array (``q`` or ``scale``) -> the layout
    ``weights.py`` gives the kernel under ``key``."""
    node = tree = {}
    path = _kernel_path(key)
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(leaf)
    return from_jax_variables({"params": tree})[key]


ZEROED = {"box_head.fc7.weight": (3,), "backbone.conv1.weight": (5,),
          "mask_head.deconv.weight": (slice(None), 2)}


@pytest.mark.parametrize("key", list(ZEROED))
def test_quantize_per_channel_is_bitwise_jax_in_torch_layout(weights, key):
    """Dense, Conv2d and the ConvTranspose2d, each with a zero output
    channel, against JAX's quantizer run eagerly, as the JAX runner runs it
    (jitted, XLA rewrites ``amax / 127`` to a multiply by the reciprocal,
    one ulp off for some channels)."""
    sd, variables = weights
    kernel = variables["params"]
    for p in _kernel_path(key):
        kernel = kernel[p]
    jq, js = JP.quantize_per_channel(jnp.asarray(kernel), axis=-1)
    ours = TQ.quantize_network(sd)[key]
    assert ours["q"].dtype == torch.int8
    np.testing.assert_array_equal(ours["q"].numpy(), _as_port(key, jq).numpy())
    np.testing.assert_array_equal(ours["scale"].numpy(), _as_port(key, js).numpy())
    np.testing.assert_array_equal(TQ.dequantize_network({key: ours})[key].numpy(),
                                  _as_port(key, JP.dequantize(jq, js, jnp.float32)).numpy())
    chan = ZEROED[key]
    assert float(ours["scale"][chan].max()) == 1.0 and not ours["q"][chan].any()


def _jax_quantized_keys(tree, path=()):
    """The state_dict keys of the kernels JAX's ``quantize_network`` turns
    into pairs (read off its output's shapes, nothing computed)."""
    for k, v in tree.items():
        if JQ.is_quantized_leaf(v):
            yield ".".join([{"rpn": "rpn_head"}.get(path[0], path[0]), *path[1:], "weight"])
        elif isinstance(v, dict):
            yield from _jax_quantized_keys(v, path + (k,))


def test_quantize_network_quantizes_what_jax_does(weights):
    """The same weights become pairs, along each one's output axis (the
    deconv's is axis 1 of its (I, O, k, k)); everything else passes
    through untouched."""
    sd, variables = weights
    ours = TQ.quantize_network(sd)
    shapes = jax.eval_shape(JQ.quantize_network, variables)
    quantized = sorted(k for k, v in ours.items() if TQ.is_quantized_leaf(v))
    assert quantized == sorted(_jax_quantized_keys(shapes["params"]))
    assert "mask_head.deconv.weight" in quantized and len(quantized) >= 20
    for key, value in ours.items():
        if TQ.is_quantized_leaf(value):
            axis = output_axis(key)
            assert value["scale"].numel() == sd[key].shape[axis] == value["scale"].shape[axis]
        else:
            assert value is sd[key]
    assert output_axis("mask_head.deconv.weight") == 1


@pytest.mark.parametrize("shape,axis", [((96, 40), 0), ((40, 96), 1), ((8, 3, 3, 3), 0),
                                        ((6, 4, 2, 2), 1)])
def test_quantize_per_channel_matches_jax(shape, axis):
    """Any axis, ties at .5 included (round half to even in both)."""
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    w.reshape(-1)[::7] = np.float32(0.5) * np.abs(w).max() / 127 * 3   # exact .5 multiples
    np.take(w, 0, axis=axis)[...] = 0.0                                  # a zero channel
    q, s = TP.quantize_per_channel(torch.from_numpy(w), axis=axis)
    jq, js = JP.quantize_per_channel(jnp.asarray(w), axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TP.dequantize(q, s, torch.float32).numpy(),
        np.asarray(JP.dequantize(jq, js, jnp.float32)))


def test_dequantize_network_is_exact(weights):
    """One f32 product of ``q`` and its channel scale (bitwise JAX's
    ``dequantize`` above), within scale / 2 of the master; biases and
    FrozenBN buffers untouched."""
    sd, _ = weights
    qn = TQ.quantize_network(sd)
    deq = TQ.dequantize_network(qn)
    assert deq.keys() == sd.keys()
    for key, value in qn.items():
        if TQ.is_quantized_leaf(value):
            np.testing.assert_array_equal(deq[key].numpy(),
                                          (value["q"].float() * value["scale"]).numpy())
            assert bool(((deq[key] - sd[key]).abs() <= value["scale"] / 2 + 1e-7).all()), key
        else:
            assert deq[key] is sd[key]


def test_apply_box_head_q8_matches_jax(weights):
    sd, variables = weights
    s = 7
    c = sd["box_head.fc6.weight"].shape[1] // (s * s)
    pooled = np.random.RandomState(1).randn(32, s, s, c).astype(np.float32)
    got = TQ.apply_box_head_q8(TQ.quantize_box_head(sd), torch.from_numpy(pooled))
    want = JQ.apply_box_head_q8(JQ.quantize_box_head(variables), jnp.asarray(pooled))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def detectors():
    cfg = get_config("tiny_synthetic")
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    port = TwoStageDetector(cfg.model, device="cpu")
    port.load_state_dict(sd)
    port.eval()
    images = np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32)
    jbatch = JaxBatch(images=jnp.asarray(images), image_hw=jnp.asarray(HW),
                      gt_boxes=jnp.zeros((2, 8, 4)), gt_classes=jnp.zeros((2, 8), jnp.int32),
                      gt_valid=jnp.zeros((2, 8), bool))
    batch = Batch(images=torch.from_numpy(images), image_hw=torch.from_numpy(HW))
    return dict(sd=sd, port=port, jmodel=JaxDetector(cfg=_jax_cfg([]).model),
                variables=to_jax_variables(sd), batch=batch, jbatch=jbatch)


def _dets(out, i):
    return unletterbox_detections(np.asarray(out.boxes[i]), np.asarray(out.scores[i]),
                                  np.asarray(out.classes[i]), np.asarray(out.valid[i]),
                                  1.0, 128, 128)


def _held(want, got):
    for i in range(2):
        ref, out = _dets(want, i), _dets(got, i)
        assert len(ref["scores"]) > 10
        assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9


def test_full_q8_program_matches_jax(detectors):
    d = detectors
    program = jax.jit(lambda v, q, b: JG.forward_inference(
        d["jmodel"], v, b, box_head_apply=functools.partial(JQ.apply_box_head_q8, q)))
    want = program(d["variables"], JQ.quantize_box_head(d["variables"]), d["jbatch"])
    with torch.inference_mode():
        got = TG.forward_inference(d["port"], d["batch"], box_head_apply=functools.partial(
            TQ.apply_box_head_q8, TQ.quantize_box_head(d["sd"])))
    _held(want, got)


def test_full_q8n_program_matches_jax(detectors):
    d = detectors
    program = jax.jit(lambda qn, b: JG.forward_inference(d["jmodel"],
                                                          JQ.dequantize_network(qn), b))
    want = program(jax.jit(JQ.quantize_network)(d["variables"]), d["jbatch"])
    # As the runner calls it: the dequantized tensors in the model's place.
    deq = {f"model.{k}": v for k, v in TQ.dequantize_network(TQ.quantize_network(d["sd"])).items()}
    with torch.inference_mode():
        got = torch.func.functional_call(_Bound(d["port"]), deq,
                                         (TG.forward_inference, d["batch"]))
    _held(want, got)
    # The rounded weights moved the detections: the program is not "full".
    with torch.inference_mode():
        full = TG.forward_inference(d["port"], d["batch"])
    assert not torch.equal(full.scores, got.scores)
