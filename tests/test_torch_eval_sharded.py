"""The port's sharded, preemptible and resumable evaluation against the
JAX package's (``mx_rcnn_tpu/evalutil/pred_eval.py``,
``tests/test_serve.py::TestShardedEval``).

Tolerances: the schedule fingerprint equal; with stand-in eval steps that
give both packages the same detections (masks included, each a constant
probability so that the paste cannot differ in a resize's last bit), every
shard file, the manifest and the merged dump byte for byte the JAX
package's; interrupted and resumed, the same bytes as uninterrupted.  End
to end on ``tiny_synthetic`` through both ``run_eval``s with
``shard_dir`` and the same weights, the tolerance of
``tests/test_torch_eval.py::test_run_eval_matches_jax_end_to_end``: per
image ``match_fraction`` >= 0.9 and every metric within 5e-3.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import jax
import numpy as np
import pytest
import torch

import mx_rcnn_tpu.data as jax_data
from mx_rcnn_tpu.cli.eval_cli import run_eval as jax_run_eval
from mx_rcnn_tpu.config import apply_overrides as jax_apply_overrides
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mx_rcnn_tpu.data.loader import DetectionLoader as JaxLoader
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.evalutil.pred_eval import collect_detections_sharded as jax_sharded
from mx_rcnn_tpu.evalutil.pred_eval import eval_schedule_fingerprint as jax_fingerprint
from mx_rcnn_tpu.evalutil.pred_eval import merge_detection_shards as jax_merge
from mx_rcnn_tpu.train.state import TrainState as JaxTrainState
from mx_rcnn_tpu_torch.cli import eval_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.data.loader import DetectionLoader
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.detection.graph import Detections
from mx_rcnn_tpu_torch.evalutil import collect_detections_sharded, merge_detection_shards
from mx_rcnn_tpu_torch.evalutil.detections import load_detections
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction
from mx_rcnn_tpu_torch.evalutil.pred_eval import MANIFEST_NAME, eval_schedule_fingerprint
from mx_rcnn_tpu_torch.train.loop import build_all
from mx_rcnn_tpu_torch.train.preemption import RESUMABLE_EXIT_CODE, Preempted
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables

torch.set_num_threads(2)

CONFIG = "tiny_synthetic"
M = 14   # the stand-in mask grid


class _JaxDets(NamedTuple):
    boxes: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    valid: np.ndarray
    masks: Optional[np.ndarray] = None


def _stand_in(image_hw: np.ndarray, with_masks: bool):
    """Detections from the batch's true sizes alone: three boxes an image
    (one past the border, clipped on the way back), the last valid on even
    rows only; with masks, one constant probability a detection, above and
    below the paste threshold."""
    hw = np.asarray(image_hw, np.float64)
    h, w = hw[:, 0:1], hw[:, 1:2]
    rows = np.arange(len(hw), dtype=np.float64)[:, None]
    boxes = np.stack([np.concatenate([1 + 0 * w, 2 + 0 * h, w / 2, h / 2], 1),
                      np.concatenate([w / 3, h / 5, w - 1, h * 0.7], 1),
                      np.concatenate([w * 0.8, h * 0.9, w * 1.3, h * 1.1], 1)], 1)
    scores = np.concatenate([h / (h + 100.0), 0.5 + 0.01 * rows, 0.1 + 0 * rows], 1)
    classes = np.tile(np.array([[1, 2, 1]], np.int32), (len(hw), 1))
    valid = np.concatenate([rows >= 0, rows >= 0, rows % 2 == 0], 1)
    masks = None
    if with_masks:
        level = np.array([0.9, 0.3, 0.7], np.float32)[None, :, None, None]
        masks = np.broadcast_to(level, (len(hw), 3, M, M)).copy()
    return (boxes.astype(np.float32), scores.astype(np.float32), classes, valid, masks)


def _jax_step(with_masks):
    return lambda variables, batch: _JaxDets(*_stand_in(np.asarray(batch.image_hw), with_masks))


def _port_step(with_masks):
    def step(model, batch):
        out = _stand_in(batch.image_hw.numpy(), with_masks)
        return Detections(*(None if x is None else torch.from_numpy(x) for x in out))
    return step


# Landscape and portrait records on a non-square canvas, some resized.
SIZES = [(96, 128), (128, 96), (60, 100), (130, 70), (96, 128), (50, 50), (80, 120),
         (120, 80), (70, 90)]
OVERRIDES = ["data.image_size=96,128", "data.short_side=96", "data.max_side=128"]


def _loaders(batch_size=3):
    rng = np.random.RandomState(4)
    ours, theirs = [], []
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        boxes, classes = np.zeros((0, 4), np.float32), np.zeros(0, np.int32)
        ours.append(RoiRecord(f"im{i}", "", h, w, boxes, classes, image_array=img))
        theirs.append(JaxRecord(f"im{i}", "", h, w, boxes, classes, image_array=img))
    data = apply_overrides(get_config(CONFIG), OVERRIDES).data
    jdata = jax_apply_overrides(jax_get_config(CONFIG), OVERRIDES).data
    return (DetectionLoader(ours, data, batch_size, "cpu", train=False),
            JaxLoader(theirs, jdata, batch_size=batch_size, train=False, prefetch=False,
                      num_workers=0, service_workers=0))


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def _run(collect, merge, step, loader, shard_dir, **kw) -> bytes:
    paths = collect(step, None, loader, str(shard_dir), **kw)
    out = str(shard_dir) + ".json"
    merge(paths, out_path=out)
    with open(out, "rb") as f:
        return f.read()


def _port_run(loader, shard_dir, with_masks=False, **kw) -> bytes:
    return _run(collect_detections_sharded, merge_detection_shards, _port_step(with_masks),
                loader, shard_dir, **kw)


def _jax_run(loader, shard_dir, with_masks=False, **kw) -> bytes:
    return _run(jax_sharded, jax_merge, _jax_step(with_masks), loader, shard_dir, **kw)


def test_fingerprint_equals_jax():
    port, ref = _loaders(batch_size=3)
    assert [[r.image_id for r in recs] for _, recs in port.eval_specs()] == \
        [[r.image_id for r in recs] for _, recs in ref.eval_specs()]
    for shard_size in (1, 2):
        assert eval_schedule_fingerprint(port, shard_size) == jax_fingerprint(ref, shard_size)
    assert eval_schedule_fingerprint(port, 2) != eval_schedule_fingerprint(port, 1)


@pytest.mark.parametrize("with_masks", [False, True], ids=["boxes", "masks"])
def test_shards_and_dump_byte_identical_to_jax(tmp_path, with_masks):
    port, ref = _loaders(batch_size=3)
    got = _port_run(port, tmp_path / "port", with_masks, shard_size=2)
    want = _jax_run(ref, tmp_path / "jax", with_masks, shard_size=2)
    assert got == want
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert sorted(files) == [MANIFEST_NAME, "shard-00000.json", "shard-00001.json"]
    dumped = json.loads(got)
    assert len(dumped) == len(SIZES)
    assert all(("masks" in d) == with_masks for d in dumped.values())


def test_interrupted_resume_is_byte_identical(tmp_path):
    port, _ = _loaders(batch_size=2)
    clean = _port_run(port, tmp_path / "clean", shard_size=1)
    done = {"images": 0}

    class GuardStub:
        @property
        def triggered(self):
            return done["images"] > 0   # trips after the first shard

    with pytest.raises(Preempted) as e:
        collect_detections_sharded(_port_step(False), None, port, str(tmp_path / "intr"),
                                   shard_size=1, guard=GuardStub(),
                                   progress=lambda n: done.update(images=n))
    assert e.value.step == 0 and e.value.ckpt_dir == str(tmp_path / "intr")
    assert [n for n in os.listdir(tmp_path / "intr") if n.startswith("shard-")] == \
        ["shard-00000.json"]
    calls = []

    def counting(model, batch):
        calls.append(1)
        return _port_step(False)(model, batch)

    resumed = _run(collect_detections_sharded, merge_detection_shards, counting, port,
                   tmp_path / "intr", shard_size=1, resume=True)
    assert resumed == clean
    assert len(calls) == len(port.eval_specs()) - 1      # only the missing shards ran
    _run(collect_detections_sharded, merge_detection_shards, counting, port, tmp_path / "intr",
         shard_size=1, resume=True)
    assert len(calls) == len(port.eval_specs()) - 1      # a complete run re-runs nothing


def test_changed_schedule_refuses_resume_and_fresh_start_deletes_stale(tmp_path):
    port, _ = _loaders(batch_size=2)
    _port_run(port, tmp_path / "s", shard_size=1)
    n_batches = len(port.eval_specs())
    assert len([n for n in os.listdir(tmp_path / "s") if n.startswith("shard-")]) == n_batches
    with pytest.raises(ValueError, match="resume refused"):
        _port_run(port, tmp_path / "s", shard_size=2, resume=True)
    _port_run(port, tmp_path / "s", shard_size=2)
    shards = sorted(n for n in os.listdir(tmp_path / "s") if n.startswith("shard-"))
    assert shards == [f"shard-{i:05d}.json" for i in range(-(-n_batches // 2))]
    with open(tmp_path / "s" / MANIFEST_NAME) as f:
        assert json.load(f)["shard_size"] == 2


def test_shard_retries_are_bounded(tmp_path):
    port, _ = _loaders(batch_size=3)
    attempts = []

    def flaky(model, batch):
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("transient")
        return _port_step(False)(model, batch)

    paths = collect_detections_sharded(flaky, None, port, str(tmp_path / "a"), shard_size=1,
                                       max_retries=1)
    assert all(os.path.exists(p) for p in paths)
    attempts.clear()

    def always_fails(model, batch):
        attempts.append(1)
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="permanent"):
        collect_detections_sharded(always_fails, None, port, str(tmp_path / "f"), shard_size=1,
                                   max_retries=2)
    assert len(attempts) == 3


def test_cli_maps_preempted_to_75(monkeypatch):
    seen = {}

    def preempted(argv=None):
        seen["argv"] = argv
        raise Preempted(1, "shards")

    monkeypatch.setattr(eval_cli, "main", preempted)
    assert eval_cli.cli(["--x"]) == RESUMABLE_EXIT_CODE == 75 and seen["argv"] == ["--x"]
    monkeypatch.setattr(eval_cli, "main", lambda argv=None: {"AP": 0.3})
    assert eval_cli.cli([]) == 0


@pytest.mark.parametrize("argv, match", [
    (["--resume"], "--resume requires"),
    (["--proposals", "p.pkl", "--shard-dir", "s"], "does not support sharded"),
    (["--proposals", "p.pkl", "--resumable"], "does not support sharded"),
], ids=["resume-alone", "proposals-shard-dir", "proposals-resumable"])
def test_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        eval_cli.main(["--config", CONFIG, "--device", "cpu", *argv])


@pytest.fixture(scope="module")
def weights():
    sd = init_variables(get_config(CONFIG).model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:3] = 3.0   # detections above the threshold
    return sd


def test_sharded_run_eval_matches_jax_end_to_end(tmp_path, monkeypatch, weights):
    """tiny_synthetic through both run_evals with shard_dir, the same
    weights and the same uint8 images; the port's merged dump is its
    unsharded dump."""
    monkeypatch.setattr(jax_data, "build_dataset", lambda cfg, split=None, train=True:
                        JaxSynthetic(image_hw=cfg.image_size, dtype="uint8"))
    v = to_jax_variables(weights)
    jstate = JaxTrainState(step=np.int32(0), params=v["params"],
                           model_state={"constants": v["constants"]}, opt_state=(),
                           rng=jax.random.PRNGKey(0))
    want = jax_run_eval(jax_get_config(CONFIG), state=jstate, dump_path=str(tmp_path / "j.json"),
                        limit=8, shard_dir=str(tmp_path / "js"), shard_size=1)
    cfg = get_config(CONFIG)
    _, _, state, _, _ = build_all(cfg, "cpu", weights)
    got = eval_cli.run_eval(cfg, state=state, dump_path=str(tmp_path / "t.json"), limit=8,
                            device="cpu", shard_dir=str(tmp_path / "ts"), shard_size=2)
    plain = eval_cli.run_eval(cfg, state=state, dump_path=str(tmp_path / "u.json"), limit=8,
                              device="cpu")
    assert got == plain
    assert open(tmp_path / "t.json", "rb").read() == open(tmp_path / "u.json", "rb").read()
    assert sorted(os.listdir(tmp_path / "ts")) == [MANIFEST_NAME] + [
        f"shard-{i:05d}.json" for i in range(-(-8 // (2 * cfg.model.test.per_device_batch)))]
    ref, out = load_detections(str(tmp_path / "j.json")), load_detections(str(tmp_path / "t.json"))
    assert ref.keys() == out.keys() and len(ref) == 8
    for k in ref:
        assert len(ref[k]["scores"]) > 10
        assert match_fraction(ref[k], out[k], min_iou=0.9, score_tol=1e-3) >= 0.9, k
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 5e-3, k
