"""The port's eval quarantine against the JAX package's eval loader.

Eight records of the tiny synthetic set, uint8 in both packages: one whose
image file does not exist, one with an inverted box, one with a class id of
``num_classes``.  JAX's ``DetectionLoader(train=False, num_classes=...)``
quarantines all three and scores them as blank images whose gt are
misses; the port's eval loader must do the same.

Tolerances: the batches bitwise (no record is resized: the canvas is the
images' size); the journals' ``image_id`` and ``reason`` lines equal; end
to end through both ``run_eval``s with the same weights, those of
``tests/test_torch_eval.py::test_run_eval_matches_jax_end_to_end``: per
image ``match_fraction`` >= 0.9 and every metric within 5e-3.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import mx_rcnn_tpu.data as jax_data
from mx_rcnn_tpu.cli.eval_cli import run_eval as jax_run_eval
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data.cache import quarantine_read as jax_quarantine_read
from mx_rcnn_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mx_rcnn_tpu.data.loader import DetectionLoader as JaxLoader
from mx_rcnn_tpu.data.loader import annotation_error as jax_annotation_error
from mx_rcnn_tpu.train.state import TrainState as JaxTrainState
from mx_rcnn_tpu_torch.cli import eval_cli
from mx_rcnn_tpu_torch.config import get_config
from mx_rcnn_tpu_torch.data import datasets as port_datasets
from mx_rcnn_tpu_torch.data.cache import quarantine_read
from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
from mx_rcnn_tpu_torch.data.loader import DetectionLoader, annotation_error
from mx_rcnn_tpu_torch.evalutil.detections import load_detections
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction
from mx_rcnn_tpu_torch.train.loop import build_all
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

torch.set_num_threads(2)

CONFIG = "tiny_synthetic"
MISSING, INVERTED, OUT_OF_RANGE = "1", "3", "5"


def _corrupt(records, missing_path: str, num_classes: int) -> list:
    out = []
    for r in records:
        if r.image_id == MISSING:
            r = dataclasses.replace(r, image_array=None, image_path=missing_path)
        elif r.image_id == INVERTED:
            r = dataclasses.replace(r, boxes=r.boxes[:, [2, 1, 0, 3]].copy())
        elif r.image_id == OUT_OF_RANGE:
            classes = r.gt_classes.copy()
            classes[0] = num_classes
            r = dataclasses.replace(r, gt_classes=classes)
        out.append(r)
    return out


def _roidbs(tmp_path):
    """(port records, JAX records): the first 8 of the synthetic val set,
    uint8 in both, corrupted alike."""
    cfg = get_config(CONFIG)
    n = cfg.model.num_classes
    missing = str(tmp_path / "missing.jpg")
    ours = SyntheticDataset(image_hw=cfg.data.image_size).roidb()[:8]
    theirs = JaxSynthetic(image_hw=cfg.data.image_size, dtype="uint8").roidb()[:8]
    return _corrupt(ours, missing, n), _corrupt(theirs, missing, n)


class _Roidb:
    def __init__(self, records):
        self.records = records

    def roidb(self):
        return list(self.records)


def test_annotation_error_checks_num_classes(tmp_path):
    ours, theirs = _roidbs(tmp_path)
    n = get_config(CONFIG).model.num_classes
    got = [annotation_error(r, n) for r in ours]
    assert got == [jax_annotation_error(r, n) for r in theirs]
    assert got[int(OUT_OF_RANGE)] == f"class id {n} >= num_classes {n}"
    assert annotation_error(ours[int(OUT_OF_RANGE)]) is None   # the train loader's check
    assert got[int(INVERTED)] == "inverted box (x2 < x1 or y2 < y1)"


def test_eval_batches_blank_and_journal_as_jax(tmp_path):
    ours, theirs = _roidbs(tmp_path)
    cfg, jcfg = get_config(CONFIG), jax_get_config(CONFIG)
    n = cfg.model.num_classes
    port = DetectionLoader(ours, cfg.data, 2, "cpu", train=False, num_classes=n,
                           quarantine_path=str(tmp_path / "port.jsonl"), io_retries=0)
    ref = JaxLoader(theirs, jcfg.data, batch_size=2, train=False, num_classes=n,
                    quarantine_path=str(tmp_path / "jax.jsonl"), io_retries=0, prefetch=False,
                    num_workers=0, service_workers=0)
    pairs = list(zip(port, ref, strict=True))
    assert len(pairs) == 4
    blank = {MISSING, INVERTED, OUT_OF_RANGE}
    for (got, recs), (want, jrecs) in pairs:
        assert [r.image_id for r in recs] == [r.image_id for r in jrecs]
        np.testing.assert_array_equal(got.images.numpy(), want.images)
        for f in ("image_hw", "gt_boxes", "gt_classes", "gt_valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
        assert got.gt_ignore is None and want.gt_ignore is None
        for i, r in enumerate(recs):
            if r.image_id in blank:
                assert not got.images[i].any() and not got.gt_valid[i].any()
            else:
                assert got.images[i].any() and got.gt_valid[i].any()
    rows = [(r["image_id"], r["reason"]) for r in quarantine_read(str(tmp_path / "port.jsonl"))]
    want = [(r["image_id"], r["reason"])
            for r in jax_quarantine_read(str(tmp_path / "jax.jsonl"))]
    assert rows == want == [(INVERTED, "annotation"), (OUT_OF_RANGE, "annotation"),
                            (MISSING, "io")]


@pytest.fixture(scope="module")
def weights():
    sd = init_variables(get_config(CONFIG).model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    return sd


def test_run_eval_quarantines_as_jax(tmp_path, monkeypatch, weights):
    """Both ``run_eval``s finish on the corrupted roidb, journal the same
    records under ``<workdir>/<name>/quarantine.jsonl`` and score alike."""
    ours, theirs = _roidbs(tmp_path)
    monkeypatch.setattr(jax_data, "build_dataset", lambda cfg, split=None, train=True:
                        _Roidb(theirs))
    monkeypatch.setattr(port_datasets, "build_dataset", lambda cfg, split=None, train=True:
                        _Roidb(ours))
    v = to_jax_variables(weights)
    jstate = JaxTrainState(step=np.int32(0), params=v["params"],
                           model_state={"constants": v["constants"]}, opt_state=(),
                           rng=jax.random.PRNGKey(0))
    jcfg = dataclasses.replace(jax_get_config(CONFIG), workdir=str(tmp_path / "jax"))
    cfg = dataclasses.replace(get_config(CONFIG), workdir=str(tmp_path / "port"))
    want = jax_run_eval(jcfg, state=jstate, dump_path=str(tmp_path / "j.json"))
    _, _, state, _, _ = build_all(cfg, "cpu", weights)
    got = eval_cli.run_eval(cfg, state=state, dump_path=str(tmp_path / "t.json"), device="cpu")
    journals = [[(r["image_id"], r["reason"]) for r in read(f"{d}/{CONFIG}/quarantine.jsonl")]
                for read, d in ((quarantine_read, cfg.workdir),
                                (jax_quarantine_read, jcfg.workdir))]
    assert journals[0] == journals[1] and len(journals[0]) == 3
    ref, out = load_detections(str(tmp_path / "j.json")), load_detections(str(tmp_path / "t.json"))
    assert ref.keys() == out.keys() and len(ref) == 8
    for k in ref:
        assert match_fraction(ref[k], out[k], min_iou=0.9, score_tol=1e-3) >= 0.9, k
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 5e-3, k
