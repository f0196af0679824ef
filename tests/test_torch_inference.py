"""The whole serving slice on ``tiny_synthetic`` against the JAX package,
same weights (carried by the bridge), same inputs.

Staged, so each stage is held as tightly as its contract allows:
  * given JAX's RPN outputs, the port's proposals are bitwise, through all
    three middles (dense, the NMS kernel's path, the fused middle);
  * given JAX's rois and pyramid, pooled features agree within 1e-5;
  * given JAX's class probabilities and deltas, detections are bitwise in
    scores, classes and validity, and boxes within 2 ulp (the decode's
    ``exp`` differs in the last bit between XLA:CPU and torch);
  * end to end, the port's detections reproduce JAX's by
    ``match_fraction`` (same class, IoU >= 0.9, score within 1e-3) for at
    least 90% of them: the convolutions sum in another order.
The engine answers requests on the CPU, refuses an unwarmed program, sheds
when its queue is full, reaches the proposals program through the degrade
ladder, and raises when no device is given and no card is present.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.detection import Batch as JaxBatch
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu.detection import graph as JG
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.transforms import letterbox, resize_linear
from mx_rcnn_tpu_torch.detection import graph as TG
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction, unletterbox_detections
from mx_rcnn_tpu_torch.serve.engine import (
    DetectorRunner,
    EngineUnavailable,
    InferenceEngine,
    Overloaded,
    build_engine,
)
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)

HW = np.array([[128.0, 128.0], [100.0, 120.0]], np.float32)


@pytest.fixture(scope="module")
def setup():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny_synthetic")
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    port = TwoStageDetector(cfg.model, device="cpu")
    port.load_state_dict(sd)
    port.eval()
    jmodel = JaxDetector(cfg=jax_get_config("tiny_synthetic").model)
    variables = to_jax_variables(sd)
    images = np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32)
    jbatch = JaxBatch(images=jnp.asarray(images), image_hw=jnp.asarray(HW),
                      gt_boxes=jnp.zeros((2, 8, 4)), gt_classes=jnp.zeros((2, 8), jnp.int32),
                      gt_valid=jnp.zeros((2, 8), bool))
    jfeats = jmodel.apply(variables, jbatch.images, method="features")
    jprops = JG._propose_on_features(jmodel, variables, jfeats, jbatch)
    return dict(cfg=cfg, sd=sd, port=port, jmodel=jmodel, variables=variables,
                images=images, jbatch=jbatch, jfeats=jfeats, jprops=jprops)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("middle", ["dense", "pallas-nms", "fused"])
def test_proposals_bitwise_given_jax_rpn_outputs(setup, middle):
    cfg = setup["cfg"].model
    jmodel, variables, jfeats = setup["jmodel"], setup["variables"], setup["jfeats"]
    rpn_out = jmodel.apply(variables, jfeats, method="rpn")
    levels = sorted(rpn_out)
    scores = jax.nn.sigmoid(jnp.concatenate([rpn_out[l][0] for l in levels], axis=1))
    deltas = jnp.concatenate([rpn_out[l][1] for l in levels], axis=1)
    anchors = TG.level_anchors(cfg, {l: _t(jfeats[l]) for l in levels})
    over = {"dense": [], "pallas-nms": ["model.rpn.nms_impl=pallas"],
            "fused": ["model.rpn.fused_middle=true"]}[middle]
    mcfg = apply_overrides(setup["cfg"], over).model
    props = TG._propose_one(mcfg)(*TG._slice_levels(levels, anchors, _t(scores), _t(deltas)),
                                  _t(HW))
    for got, want in zip(props, setup["jprops"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert props.valid.sum() > 10


def test_pooled_features_given_jax_rois(setup):
    cfg, jfeats, jprops = setup["cfg"].model, setup["jfeats"], setup["jprops"]
    jmodel = setup["jmodel"]
    want = JG._pool_rois(jmodel.cfg, jfeats, jprops.rois, 7, jmodel.roi_levels)
    got = TG._pool_rois_impl(cfg, {l: _t(f) for l, f in jfeats.items()}, _t(jprops.rois), 7,
                             setup["port"].roi_levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_detections_given_jax_probabilities_and_deltas(setup):
    cfg, jprops = setup["cfg"].model, setup["jprops"]
    rng = np.random.RandomState(1)
    b, r = jprops.rois.shape[:2]
    logits = rng.randn(b, r, cfg.num_classes).astype(np.float32) * 2
    logits[..., 1:3] += 2.0
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    deltas = jnp.asarray(rng.randn(b, r, cfg.num_classes, 4).astype(np.float32) * 0.5)
    jcfg = setup["jmodel"].cfg
    want = jax.vmap(lambda ro, rv, p, d, hw: JG._postprocess_one_fused(jcfg, ro, rv, p, d, hw))(
        jprops.rois, jprops.valid, probs, deltas, jnp.asarray(HW))
    got = TG._postprocess_one_fused(cfg, _t(jprops.rois), _t(jprops.valid), _t(probs),
                                    _t(deltas), _t(HW))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    wb = np.asarray(want[0])
    ulp = np.spacing(np.abs(wb).max(axis=-1, keepdims=True).astype(np.float32))
    assert np.all(np.abs(got[0].numpy() - wb) <= 2 * ulp)
    assert got[3].sum() > 20


def _dets(dets, i):
    boxes, scores, classes, valid = (np.asarray(x[i]) for x in dets[:4])
    return unletterbox_detections(boxes, scores, classes, valid, 1.0, 128, 128)


def test_end_to_end_detections_match_jax(setup):
    want = JG.forward_inference(setup["jmodel"], setup["variables"], setup["jbatch"])
    with torch.inference_mode():
        got = TG.forward_inference(setup["port"], Batch(images=_t(setup["images"]),
                                                        image_hw=_t(HW)))
    for i in range(2):
        ref, out = _dets(want, i), _dets(got, i)
        assert len(ref["scores"]) > 10
        assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9


def test_forward_proposals_scores_are_float32(setup):
    with torch.inference_mode():
        props = TG.forward_proposals(setup["port"], Batch(images=_t(setup["images"]),
                                                          image_hw=_t(HW)))
    assert props.scores.dtype == torch.float32 and props.rois.shape == (2, 64, 4)


def test_per_class_postprocess_is_not_ported(setup):
    """Once a refusal, now ported: ``test.nms_mode="per_class"`` end to end
    reproduces JAX's per-class detections as the fused mode does above; an
    unknown mode still raises."""
    cfg = apply_overrides(setup["cfg"], ["model.test.nms_mode=per_class"])
    model = TwoStageDetector(cfg.model, device="cpu")
    model.load_state_dict(setup["sd"])
    jmodel = JaxDetector(cfg=apply_overrides(setup["jmodel"].cfg, ["test.nms_mode=per_class"]))
    want = JG.forward_inference(jmodel, setup["variables"], setup["jbatch"])
    with torch.inference_mode():
        got = TG.forward_inference(model, Batch(images=_t(setup["images"]), image_hw=_t(HW)))
    for i in range(2):
        ref, out = _dets(want, i), _dets(got, i)
        assert len(ref["scores"]) > 10
        assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9
    bad = TwoStageDetector(apply_overrides(setup["cfg"], ["model.test.nms_mode=nope"]).model,
                           device="cpu")
    with pytest.raises(ValueError, match="nms_mode"):
        TG.forward_inference(bad, Batch(images=_t(setup["images"]), image_hw=_t(HW)))


def test_engine_serves_requests_on_cpu(setup):
    cfg = apply_overrides(setup["cfg"], ["serve.fused_middle=on", "serve.batch_size=2"])
    rng = np.random.RandomState(2)
    images = [rng.uniform(0, 255, (h, w, 3)) for h, w in ((128, 128), (90, 120), (60, 40))]
    with build_engine(cfg, setup["sd"], device="cpu") as engine:
        results = [r.result(120) for r in [engine.submit(img) for img in images]]
        with pytest.raises(EngineUnavailable):
            engine.runner.run("full", (64, 64), images[:1])
    assert engine.stats()["served"] == {"full": 3}
    assert [r["level"] for r in results] == ["full"] * 3
    for img, res in zip(images, results):
        h, w = img.shape[:2]
        assert res["boxes"].shape == (len(res["scores"]), 4) and len(res["scores"]) > 0
        assert np.isfinite(res["boxes"]).all() and res["boxes"].min() >= 0
        assert res["boxes"][:, 0::2].max() <= w - 1 and res["boxes"][:, 1::2].max() <= h - 1
    with pytest.raises(EngineUnavailable):
        engine.submit(images[0])


def test_engine_packs_requests_by_bucket(setup):
    cfg = apply_overrides(setup["cfg"], ["serve.batch_size=2"])
    sizes = ((60, 50), (120, 100), (50, 64), (128, 128))
    images = [np.random.RandomState(i).uniform(0, 255, (*hw, 3)) for i, hw in enumerate(sizes)]
    engine = build_engine(cfg, setup["sd"], buckets=[(128, 128), (64, 64)], device="cpu")
    runner = engine.runner
    assert runner.buckets == [(64, 64), (128, 128)]
    calls = []
    run = runner.run

    def recording_run(mode, bucket, imgs):
        calls.append((bucket, [img.shape[:2] for img in imgs]))
        return run(mode, bucket, imgs)

    runner.run = recording_run
    with engine:
        results = [r.result(120) for r in [engine.submit(img) for img in images]]
    # Every device call holds at most batch_size images of its own bucket.
    assert sum(len(shapes) for _, shapes in calls) == 4
    for bucket, shapes in calls:
        assert 1 <= len(shapes) <= 2
        assert all(runner.pick_bucket(*hw) == bucket for hw in shapes)
    for img, res in zip(images, results):
        assert res["boxes"][:, 0::2].max() <= img.shape[1] - 1
        assert res["boxes"][:, 1::2].max() <= img.shape[0] - 1


def test_engine_proposals_mode_and_overload(setup):
    """The proposals program, reached through the ladder (a deadline that no
    better level's estimate fits), and the queue shedding when full."""
    cfg = apply_overrides(setup["cfg"], ["model.rpn.nms_impl=pallas"])
    engine = build_engine(cfg, setup["sd"], device="cpu", max_queue=1)
    release = threading.Event()
    run = engine.runner.run

    def held_run(*args):
        release.wait(60)
        return run(*args)

    with engine:
        assert engine.runner.levels()[-1] == "proposals"
        for level in engine.runner.levels()[:-1]:
            engine.estimates.observe(level, 1e3)
        engine.runner.run = held_run
        first = engine.submit(np.zeros((64, 64, 3)), timeout=120)
        while engine._queue.qsize():      # the worker holds the first request
            threading.Event().wait(0.01)
        engine.submit(np.zeros((64, 64, 3)))
        with pytest.raises(Overloaded):
            engine.submit(np.zeros((64, 64, 3)))
        release.set()
        res = first.result(60)
    assert engine.stats()["shed"] == 1 and res["level"] == "proposals"
    assert res["boxes"].shape[1] == 4 and (res["classes"] == 0).all()


def test_no_device_means_the_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(setup["cfg"], setup["sd"])
    # No mode is chosen by the caller: the ladder picks a program per
    # request, and a program outside the warmed set is refused.
    with pytest.raises(TypeError):
        build_engine(setup["cfg"], setup["sd"], device="cpu", mode="proposals")
    with pytest.raises(EngineUnavailable):
        InferenceEngine(DetectorRunner(setup["cfg"], setup["sd"], device="cpu")).runner.run(
            "masks", (128, 128), [np.zeros((8, 8, 3))])


def test_resize_matches_cv2_bilinear():
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(3).uniform(0, 255, (97, 131, 3)).astype(np.float32)
    for nh, nw in ((150, 200), (80, 100), (97, 131)):
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(torch.from_numpy(img), nh, nw).numpy()
        # cv2 rounds its interpolation weights in its own way: 5e-3 of 255.
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    canvas, scale, (nh, nw) = letterbox(torch.from_numpy(img), (128, 128), 128, 128)
    assert (nh, nw) == (95, 128) and scale == pytest.approx(128 / 131)
    assert canvas.shape == (128, 128, 3) and not canvas[nh:].any()
