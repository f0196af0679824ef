"""The port's submission files, ``reeval_cli`` and shared CLI arguments
against the JAX package's (``mx_rcnn_tpu/evalutil/submission.py``,
``cli/reeval_cli.py``, ``cli/common.py``; ``tests/test_eval.py``'s
``TestSubmissionFormats`` and ``tests/test_cli.py``'s up-front
``--dump-voc`` refusal).

Tolerances: the COCO results json and the comp4 files byte for byte the
JAX package's for the same detections; their read-backs equal to the JAX
readers' and scored to metrics equal exactly; against the detections
before the write, the JAX tests' bounds for the wire format's rounding
(1e-3 COCO: boxes to 2 decimals, scores to 5; 2e-2 VOC: 1 and 3);
``reeval_cli.main`` exactly JAX's metrics and files; the shared
arguments give equal values in every config field both packages have.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import types

import numpy as np
import pytest

from mx_rcnn_tpu.cli import common as jax_common
from mx_rcnn_tpu.cli import reeval_cli as jax_reeval
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.evalutil import evaluate_detections as jax_evaluate
from mx_rcnn_tpu.evalutil import submission as JS
from mx_rcnn_tpu_torch.cli import common, eval_cli, reeval_cli
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.data.datasets import build_dataset
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.evalutil import evaluate_detections
from mx_rcnn_tpu_torch.evalutil import submission as TS
from mx_rcnn_tpu_torch.evalutil.detections import save_detections
from mx_rcnn_tpu_torch.evalutil.masks import rle_encode

NAMES = ("__background__", "cat", "dog", "bird")
LABEL_TO_CAT = {1: 1, 2: 3, 3: 90}


def _per_image(with_masks: bool) -> dict:
    """Four detections an image, zero-padded, canonical and non-numeric ids."""
    rng = np.random.RandomState(3)
    out = {}
    for img in ("11", "000005", "img_7"):
        n = 4
        x1, y1 = rng.uniform(0, 60, n), rng.uniform(0, 60, n)
        w, h = rng.uniform(5, 30, n), rng.uniform(5, 30, n)
        entry = {"boxes": np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32),
                 "scores": rng.rand(n).astype(np.float32),
                 "classes": rng.randint(1, 4, n).astype(np.int32)}
        if with_masks:
            entry["masks"] = [rle_encode(rng.rand(100, 100) > 0.6) for _ in range(n)]
        out[img] = entry
    return out


def _roidbs(per_image):
    rng = np.random.RandomState(9)
    ours, theirs = [], []
    for img, d in per_image.items():
        gt = d["boxes"] + rng.uniform(-3, 3, d["boxes"].shape).astype(np.float32)
        ours.append(RoiRecord(img, "", 100, 100, gt, d["classes"]))
        theirs.append(JaxRecord(img, "", 100, 100, gt, d["classes"]))
    return ours, theirs


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("with_masks", [False, True], ids=["boxes", "masks"])
@pytest.mark.parametrize("label_to_cat", [None, LABEL_TO_CAT], ids=["dense", "sparse"])
def test_coco_results_byte_identical_and_round_trip(tmp_path, with_masks, label_to_cat):
    per_image = _per_image(with_masks)
    n = TS.write_coco_results(str(tmp_path / "t.json"), per_image, label_to_cat)
    assert n == JS.write_coco_results(str(tmp_path / "j.json"), per_image, label_to_cat) == 12
    assert _read(tmp_path / "t.json") == _read(tmp_path / "j.json")
    with open(tmp_path / "t.json") as f:
        ids = {r["image_id"] for r in json.load(f)}
    assert ids == {11, "000005", "img_7"}          # zero-padded ids kept as strings
    cat_to_label = None if label_to_cat is None else {v: k for k, v in label_to_cat.items()}
    back = TS.read_coco_results(str(tmp_path / "t.json"), cat_to_label)
    jback = JS.read_coco_results(str(tmp_path / "j.json"), cat_to_label)
    ours, theirs = _roidbs(per_image)
    got = evaluate_detections(back, ours, num_classes=4, style="coco")
    assert got == jax_evaluate(jback, theirs, num_classes=4, style="coco")
    before = evaluate_detections(per_image, ours, num_classes=4, style="coco")
    assert got.keys() == before.keys() and any(k.startswith("segm/") for k in got) == with_masks
    for k in before:
        assert got[k] == pytest.approx(before[k], abs=1e-3), k


def test_voc_dets_byte_identical_and_round_trip(tmp_path):
    per_image = _per_image(False)
    paths = TS.write_voc_dets(str(tmp_path / "t"), per_image, NAMES, imageset="test")
    jpaths = JS.write_voc_dets(str(tmp_path / "j"), per_image, NAMES, imageset="test")
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths] == [
        "comp4_det_test_cat.txt", "comp4_det_test_dog.txt", "comp4_det_test_bird.txt"]
    assert [_read(p) for p in paths] == [_read(p) for p in jpaths]
    back = TS.read_voc_dets(str(tmp_path / "t"), NAMES, imageset="test")
    jback = JS.read_voc_dets(str(tmp_path / "j"), NAMES, imageset="test")
    ours, theirs = _roidbs(per_image)
    got = evaluate_detections(back, ours, 4, style="voc", class_names=NAMES)
    assert got == jax_evaluate(jback, theirs, 4, style="voc", class_names=NAMES)
    before = evaluate_detections(per_image, ours, 4, style="voc", class_names=NAMES)
    for k in before:
        assert got[k] == pytest.approx(before[k], abs=2e-2), k


def test_empty_class_still_writes_file_and_nameless_voc_is_refused(tmp_path):
    per_image = {"1": {"boxes": np.array([[0, 0, 5, 5]], np.float32),
                       "scores": np.array([0.9], np.float32),
                       "classes": np.array([1], np.int32)}}
    paths = TS.write_voc_dets(str(tmp_path), per_image, ("bg", "cat", "dog"), imageset="val")
    assert all(os.path.exists(p) for p in paths) and os.path.getsize(paths[1]) == 0
    with pytest.raises(ValueError, match="foreground class names"):
        TS.write_submission_artifacts(per_image, voc_dets_dir=str(tmp_path / "v"),
                                      class_names=("__background__",))


def test_coco_image_id_is_lossless():
    for iid in ("000005", "5", "-3", "img_001"):
        assert TS._coco_image_id(iid) == JS._coco_image_id(iid)
    assert TS._coco_image_id("000005") == "000005" and TS._coco_image_id("5") == 5


def test_reeval_matches_jax(tmp_path, capsys):
    """The same dump and config through both ``reeval_cli.main``s, with
    ``--dump-coco`` and ``--dump-voc``: equal metrics, equal files."""
    cfg = get_config("tiny_synthetic")
    roidb = build_dataset(cfg.data, train=False).roidb()
    rng = np.random.RandomState(5)
    dets = {}
    for rec in roidb:
        n = rng.randint(0, 6)
        keep = rng.rand(len(rec.boxes)) < 0.7
        jitter = rng.uniform(-2, 2, (keep.sum(), 4))
        boxes = np.concatenate([rec.boxes[keep] + jitter, rng.uniform(0, 100, (n, 4))]).clip(0)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        dets[rec.image_id] = {
            "boxes": boxes, "scores": rng.rand(len(boxes)),
            "classes": np.concatenate([rec.gt_classes[keep], rng.randint(1, 5, n)])}
    dump = str(tmp_path / "d.json")
    save_detections(dump, dets)
    got = reeval_cli.main([dump, "--config", "tiny_synthetic", "--dump-coco",
                           str(tmp_path / "t.json"), "--dump-voc", str(tmp_path / "tv")])
    printed = capsys.readouterr().out.strip().splitlines()
    want = jax_reeval.main([dump, "--config", "tiny_synthetic", "--dump-coco",
                            str(tmp_path / "j.json"), "--dump-voc", str(tmp_path / "jv")])
    assert got == want and got["AP"] > 0
    assert printed == [f"{k} = {v:.4f}" for k, v in sorted(got.items())]
    assert _read(tmp_path / "t.json") == _read(tmp_path / "j.json")
    names = sorted(os.listdir(tmp_path / "tv"))
    assert names == sorted(os.listdir(tmp_path / "jv")) and len(names) == 4
    assert all(_read(tmp_path / "tv" / n) == _read(tmp_path / "jv" / n) for n in names)
    assert reeval_cli.cli([dump, "--config", "tiny_synthetic"]) == 0


def test_dump_voc_without_class_names_is_refused_before_inference(monkeypatch):
    from mx_rcnn_tpu_torch.train.loop import build_all

    cfg = get_config("tiny_synthetic")
    _, _, state, _, _ = build_all(cfg, "cpu")
    monkeypatch.setattr(eval_cli, "_eval_loader",
                        lambda *a, **k: (types.SimpleNamespace(), [], iter(())))
    pred_eval_module = importlib.import_module("mx_rcnn_tpu_torch.evalutil.pred_eval")

    def boom(*a, **k):
        raise AssertionError("pred_eval reached despite an invalid --dump-voc")

    monkeypatch.setattr(pred_eval_module, "pred_eval", boom)
    with pytest.raises(ValueError, match="foreground class names"):
        eval_cli.run_eval(cfg, state=state, voc_dets_dir="/nonexistent/voc", device="cpu")


def _shared(a, b) -> dict:
    """The fields of two config dataclasses that both have, recursively:
    {dotted name: (port value, JAX value)}."""
    out = {}
    for f in dataclasses.fields(a):
        if not hasattr(b, f.name):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            out.update({f"{f.name}.{k}": v for k, v in _shared(x, y).items()})
        else:
            out[f.name] = (x, y)
    return out


@pytest.mark.parametrize("argv", [
    ["--config", "tiny_synthetic"],
    ["--config", "vgg16_voc07", "--workdir", "runs/x", "-v", "--set", "data.dataset=voc",
     "--set", "data.val_split=2007_test"],
    ["--set", "train.schedule.total_steps=7", "--set", "model.rpn.test_post_nms_top_n=50",
     "--set", "data.image_size=608,1024"],
], ids=["tiny", "voc-workdir", "overrides"])
def test_config_args_match_jax(argv):
    import argparse

    parsed = []
    for mod in (common, jax_common):
        p = argparse.ArgumentParser()
        mod.add_config_args(p)
        parsed.append(p.parse_args(argv))
    ours, theirs = parsed
    assert vars(ours) == vars(theirs)
    cfg, jcfg = common.config_from_args(ours), jax_common.config_from_args(theirs)
    fields = _shared(cfg, jcfg)
    assert len(fields) > 50 and "workdir" in fields and "data.image_size" in fields
    assert {k: v[0] for k, v in fields.items()} == {k: v[1] for k, v in fields.items()}
    assert common.default_use_07_metric(cfg) == jax_common.default_use_07_metric(jcfg)
    assert common.submission_imageset(cfg) == jax_common.submission_imageset(jcfg)
    if "--workdir" in argv:
        assert cfg.workdir == "runs/x" and ours.verbose
