"""The port's evaluation path against the JAX package.

Tolerances:
  * the COCO and VOC evaluators, the matcher and the detection dump are
    copies in numpy: the same detections and roidb give metrics dicts
    equal bit for bit (crowd and difficult regions included);
  * ``_postprocess_one`` against JAX's (jitted on the CPU) on random rois,
    probabilities and deltas: classes, validity and scores bitwise (the
    scores are selected, never computed), boxes within 2 ulp of the row's
    largest coordinate (the decode's ``exp`` differs in the last bit
    between XLA:CPU and torch).  Port only: per class equals fused when no
    candidate cap binds, boxes within 1e-4;
  * ``collect_detections`` over landscape and portrait records with a
    stand-in eval step: per-image detections bitwise (schedule, padding
    and each record's un-letterboxing);
  * end to end on ``tiny_synthetic``, the same weights (carried by the
    bridge) and the same uint8 synthetic images through JAX's ``run_eval``
    and the port's: per image, ``match_fraction`` (same class, IoU >= 0.9,
    score within 1e-3) >= 0.9 as in ``test_torch_inference.py``, and every
    metric within 5e-3 (the convolutions sum in another order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mx_rcnn_tpu.data as jax_data
from mx_rcnn_tpu.cli.eval_cli import run_eval as jax_run_eval
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.detection import graph as JG
from mx_rcnn_tpu.evalutil import coco_eval as JCE
from mx_rcnn_tpu.evalutil import evaluate_detections as jax_evaluate_detections
from mx_rcnn_tpu.evalutil.detections import load_detections as jax_load_detections
from mx_rcnn_tpu.train.state import TrainState as JaxTrainState
from mx_rcnn_tpu_torch.cli import eval_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.detection import graph as TG
from mx_rcnn_tpu_torch.evalutil import coco_eval as TCE
from mx_rcnn_tpu_torch.evalutil import pred_eval as TPE
from mx_rcnn_tpu_torch.evalutil.detections import load_detections, save_detections
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction
from mx_rcnn_tpu_torch.evalutil.voc_eval import voc_mean_ap
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.train.loop import build_all, train
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

torch.set_num_threads(2)


def _boxes(rng, n, hw=200.0):
    xy = rng.uniform(0, hw, (n, 2))
    wh = rng.uniform(3, 120, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _problem(seed, n_images=12, num_classes=5):
    """Both packages' roidbs (gt with crowd/difficult regions) and one
    detections dict: jittered gt, duplicates and background boxes."""
    rng = np.random.RandomState(seed)
    ours, theirs, dets = [], [], {}
    for i in range(n_images):
        g = rng.randint(0, 7)
        gt = _boxes(rng, g)
        gcls = rng.randint(1, num_classes, g).astype(np.int32)
        ign = rng.rand(g) < 0.25
        order = np.argsort(ign, kind="mergesort")   # non-ignore first, as the readers do
        gt, gcls, ign = gt[order], gcls[order], ign[order]
        ours.append(RoiRecord(f"im{i}", "", 300, 400, gt, gcls, ignore=ign))
        theirs.append(JaxRecord(f"im{i}", "", 300, 400, gt, gcls, ignore=ign))
        d = rng.randint(0, 15)
        pick = rng.randint(0, max(g, 1), d)
        boxes = np.where(rng.rand(d, 1) < 0.7,
                         (gt[pick] if g else _boxes(rng, d)) + rng.uniform(-15, 15, (d, 4)),
                         _boxes(rng, d)).astype(np.float32)
        cls = np.where(rng.rand(d) < 0.8, gcls[pick] if g else 1,
                       rng.randint(1, num_classes, d)).astype(np.int32)
        if i != 3:   # one image with no detections entry at all
            dets[f"im{i}"] = {"boxes": boxes, "scores": rng.rand(d).astype(np.float32),
                              "classes": cls}
    return ours, theirs, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("style", ["coco", "voc"])
def test_evaluators_match_jax_bitwise(seed, style):
    ours, theirs, dets = _problem(seed)
    names = ("__background__", "a", "b", "c", "d")
    got = TPE.evaluate_detections(dets, ours, 5, style, names, use_07_metric=seed == 1)
    want = jax_evaluate_detections(dets, theirs, 5, style, names, use_07_metric=seed == 1)
    assert got == want
    assert any(r.ignore_flags.any() for r in ours) and np.isfinite(list(got.values())).all()


def test_voc_mean_ap_matches_jax():
    from mx_rcnn_tpu.evalutil.voc_eval import voc_mean_ap as jax_voc_mean_ap

    rng = np.random.RandomState(3)
    dets = {1: {"a": np.c_[_boxes(rng, 5), rng.rand(5)], "b": np.zeros((0, 5))},
            2: {"a": np.c_[_boxes(rng, 2), rng.rand(2)]}}
    gt = {1: {"a": {"boxes": _boxes(rng, 3), "difficult": np.array([0, 1, 0], bool)}},
          2: {}}
    for m07 in (False, True):
        assert voc_mean_ap(dets, gt, ("bg", "x", "y"), use_07_metric=m07) == \
            jax_voc_mean_ap(dets, gt, ("bg", "x", "y"), use_07_metric=m07)


def test_greedy_match_matches_jax_reference():
    rng = np.random.RandomState(0)
    for trial in range(200):
        d, g = rng.randint(0, 12), rng.randint(0, 10)
        ious = rng.randint(0, 8, (d, g)) / 7.0         # coarse: ties exercise last-tie-wins
        g_ignore = rng.rand(g) < 0.4
        g_crowd = g_ignore & (rng.rand(g) < 0.5)
        order = np.argsort(g_ignore, kind="mergesort")
        ious, g_ignore, g_crowd = ious[:, order], g_ignore[order], g_crowd[order]
        want = JCE._greedy_match_reference(ious, g_ignore, g_crowd)
        got = TCE._greedy_match(ious, g_ignore, g_crowd)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"trial {trial}")
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"trial {trial}")


def test_dump_load_reevaluate(tmp_path):
    ours, theirs, dets = _problem(5)
    save_detections(str(tmp_path / "d.json"), dets)
    loaded = load_detections(str(tmp_path / "d.json"))
    theirs_loaded = jax_load_detections(str(tmp_path / "d.json"))
    assert loaded.keys() == theirs_loaded.keys()
    for k in loaded:
        for f in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(loaded[k][f], dets[k][f])
            np.testing.assert_array_equal(loaded[k][f], theirs_loaded[k][f])
    assert TPE.evaluate_detections(loaded, ours, 5) == TPE.evaluate_detections(dets, ours, 5)


def _post_inputs(seed, b=2, r=50, c=11, hw=128, agnostic=False):
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, hw - 24, (b, r, 1)), rng.uniform(0, hw - 24, (b, r, 1))
    ww, hh = rng.uniform(8, 48, (b, r, 1)), rng.uniform(8, 48, (b, r, 1))
    rois = np.concatenate([x1, y1, np.minimum(x1 + ww, hw - 1), np.minimum(y1 + hh, hw - 1)],
                          -1).astype(np.float32)
    roi_valid = rng.rand(b, r) < 0.9
    probs = np.asarray(jax.nn.softmax(jnp.asarray(rng.randn(b, r, c) * 2, jnp.float32)))
    deltas = (rng.randn(b, r, 1 if agnostic else c, 4) * 0.5).astype(np.float32)
    image_hw = np.array([[hw, hw], [hw - 28, hw - 8]], np.float32)
    return rois, roi_valid, probs, deltas, image_hw


def _model_cfgs(num_classes, agnostic=False, **test):
    out = []
    for m in (get_config("tiny_synthetic").model, jax_get_config("tiny_synthetic").model):
        out.append(dataclasses.replace(
            m, num_classes=num_classes,
            rcnn=dataclasses.replace(m.rcnn, class_agnostic=agnostic),
            test=dataclasses.replace(m.test, **test)))
    return out


CASES = {
    "slack": dict(c=11, r=50),
    "per-class-cap-binds": dict(c=81, r=300),
    "agnostic": dict(c=11, r=50, agnostic=True),
    "high-threshold": dict(c=11, r=50, test=dict(score_threshold=0.6)),
    "sweep-cap": dict(c=11, r=120, test=dict(nms_sweep_cap=2, nms_threshold=0.3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_postprocess_one_matches_jax(case):
    spec = CASES[case]
    cfg, jcfg = _model_cfgs(spec["c"], spec.get("agnostic", False), **spec.get("test", {}))
    args = _post_inputs(0, r=spec["r"], c=spec["c"], agnostic=spec.get("agnostic", False))
    want = jax.jit(jax.vmap(lambda *a: JG._postprocess_one(jcfg, *a)))(*args)
    got = TG._postprocess_one(cfg, *(torch.from_numpy(x.copy()) for x in args))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    wb = np.asarray(want[0])
    ulp = np.spacing(np.abs(wb).max(axis=-1, keepdims=True).astype(np.float32))
    assert np.all(np.abs(got[0].numpy() - wb) <= 2 * ulp)
    assert got[2].dtype == torch.int32 and 0 < int(got[3].sum())
    if case == "high-threshold":
        assert not got[3].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_class_equals_fused_when_no_cap_binds(seed):
    # r = 50 <= per_class_k and r * (c - 1) = 500 <= fused_top_k: no truncation.
    cfg, _ = _model_cfgs(11)
    args = [torch.from_numpy(x.copy()) for x in _post_inputs(seed)]
    a = TG._postprocess_one(cfg, *args)
    f = TG._postprocess_one_fused(cfg, *args)
    for i in (1, 2, 3):
        assert torch.equal(a[i], f[i])
    torch.testing.assert_close(a[0], f[0], rtol=1e-6, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    sd = init_variables(get_config("tiny_synthetic").model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    return sd


def _jax_state(sd):
    v = to_jax_variables(sd)
    return JaxTrainState(step=np.int32(0), params=v["params"],
                         model_state={"constants": v["constants"]}, opt_state=(),
                         rng=jax.random.PRNGKey(0))


@pytest.mark.parametrize("nms_mode", ["fused", "per_class"])
def test_run_eval_matches_jax_end_to_end(tmp_path, monkeypatch, weights, nms_mode):
    """The port's loader renders the synthetic set in uint8; the JAX side
    is given the same uint8 set (its own build_dataset renders float32)."""
    monkeypatch.setattr(jax_data, "build_dataset", lambda cfg, split=None, train=True:
                        JaxSynthetic(image_hw=cfg.image_size, dtype="uint8"))
    over = [f"model.test.nms_mode={nms_mode}"]
    cfg = apply_overrides(get_config("tiny_synthetic"), over)
    want = jax_run_eval(apply_overrides(jax_get_config("tiny_synthetic"), over),
                        state=_jax_state(weights), dump_path=str(tmp_path / "j.json"), limit=8)
    _, _, state, _, _ = build_all(cfg, "cpu", weights)
    got = eval_cli.run_eval(cfg, state=state, dump_path=str(tmp_path / "t.json"), limit=8,
                            device="cpu")
    ref, out = load_detections(str(tmp_path / "j.json")), load_detections(str(tmp_path / "t.json"))
    assert ref.keys() == out.keys() and len(ref) == 8
    for k in ref:
        assert len(ref[k]["scores"]) > 10
        assert match_fraction(ref[k], out[k], min_iou=0.9, score_tol=1e-3) >= 0.9, k
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 5e-3, k


def _stand_in_detections(image_hw: np.ndarray):
    """Detections that depend only on the batch's true sizes and rows: a
    box over the whole image, an inner one, one past the border (clipped
    on the way back), the last valid on even rows only."""
    h, w = image_hw[:, 0:1], image_hw[:, 1:2]
    rows = np.arange(len(image_hw), dtype=np.float32)[:, None]
    boxes = np.stack([
        np.concatenate([0 * w, 0 * h, w - 1, h - 1], 1),
        np.concatenate([w / 4, h / 4, w / 2, h / 2], 1),
        np.concatenate([w * 0.9, h * 0.9, w * 1.2, h * 1.2], 1),
    ], 1).astype(np.float32)
    scores = np.concatenate([0.9 + 0 * rows, 0.5 + 0.01 * rows, 0.1 + 0 * rows], 1)
    classes = np.tile(np.array([[1, 2, 1]], np.int32), (len(image_hw), 1))
    valid = np.concatenate([rows >= 0, rows >= 0, rows % 2 == 0], 1)
    return boxes, scores.astype(np.float32), classes, valid


def test_collect_detections_matches_jax_on_mixed_orientations():
    """Landscape and portrait records, some resized, on a non-square
    canvas through both packages' ``collect_detections`` with a stand-in
    eval step: the same schedule, padding (batch 3) and per-record
    un-letterboxing give the same per-image detections, bitwise."""
    from mx_rcnn_tpu.data.loader import DetectionLoader
    from mx_rcnn_tpu.detection.graph import Detections as JaxDetections
    from mx_rcnn_tpu.evalutil import collect_detections as jax_collect_detections
    from mx_rcnn_tpu_torch.data.loader import eval_batches
    from mx_rcnn_tpu_torch.detection.graph import Detections

    sizes = [(96, 128), (128, 96), (60, 100), (130, 70), (96, 128), (50, 50)]
    rng = np.random.RandomState(4)
    ours, theirs = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        boxes, classes = np.zeros((0, 4), np.float32), np.zeros(0, np.int32)
        ours.append(RoiRecord(f"im{i}", "", h, w, boxes, classes, image_array=img))
        theirs.append(JaxRecord(f"im{i}", "", h, w, boxes, classes, image_array=img))
    over = ["data.image_size=96,128", "data.short_side=96", "data.max_side=128"]
    data = apply_overrides(get_config("tiny_synthetic"), over).data
    jdata = apply_overrides(jax_get_config("tiny_synthetic"), over).data

    def jax_step(variables, batch):
        return JaxDetections(*_stand_in_detections(np.asarray(batch.image_hw)))

    def port_step(model, batch):
        return Detections(*(torch.from_numpy(x) for x in
                            _stand_in_detections(batch.image_hw.numpy())))

    loader = DetectionLoader(theirs, jdata, batch_size=3, train=False, prefetch=False,
                             num_workers=0, service_workers=0)
    want = jax_collect_detections(jax_step, None, loader)
    got = TPE.collect_detections(port_step, None, eval_batches(ours, data, 3, "cpu"), data)
    assert got.keys() == want.keys() == {r.image_id for r in ours}
    for k in want:
        for f in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[k][f], want[k][f], err_msg=f"{k} {f}")
    assert got["im1"]["boxes"][0].tolist() == [0, 0, 95, 127]    # portrait, unscaled
    # Rows: landscape [im0, im2, im4], [im5, pad, pad]; portrait [im1, im3, pad].
    assert [len(got[f"im{i}"]["scores"]) for i in range(6)] == [3, 3, 2, 2, 3, 3]


def test_metrics_invariant_to_eval_batch():
    """test.per_device_batch does not change the metrics: a short last
    batch is padded, and only its real records score."""
    cfg = get_config("tiny_synthetic")
    state = train(cfg, steps=2, device="cpu", log=lambda line: None)
    m1 = eval_cli.run_eval(cfg, state=state, limit=7, device="cpu")
    m3 = eval_cli.run_eval(apply_overrides(cfg, ["model.test.per_device_batch=3"]), state=state,
                           limit=7, device="cpu")
    assert set(m1) == set(m3)
    for k in m1:
        np.testing.assert_allclose(m1[k], m3[k], atol=1e-6, err_msg=k)


def test_train_then_eval_cli_on_cpu(tmp_path, capsys):
    from mx_rcnn_tpu_torch.cli import train_cli

    train_cli.main(["--config", "tiny_synthetic", "--steps", "2", "--device", "cpu",
                    "--workdir", str(tmp_path), "--set", "train.checkpoint_every=1"])
    capsys.readouterr()
    ckpt = tmp_path / "tiny_synthetic" / "ckpt"
    metrics = eval_cli.main(["--config", "tiny_synthetic", "--ckpt", str(ckpt), "--limit", "4",
                             "--device", "cpu", "--step", "1", "--dump", str(tmp_path / "d.json")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"{k} = {v:.4f}" for k, v in sorted(metrics.items())]
    assert np.isfinite(list(metrics.values())).all() and "AP" in metrics
    assert len(load_detections(str(tmp_path / "d.json"))) == 4


def test_eval_refuses_without_a_card(monkeypatch, weights):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny_synthetic")
    _, _, state, _, _ = build_all(cfg, "cpu", weights)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.run_eval(cfg, state=state, limit=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main(["--config", "tiny_synthetic", "--limit", "1"])
