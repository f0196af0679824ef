"""Fast R-CNN mode (external proposals) against the JAX package, on
``tiny_synthetic`` and the loader's own small roidbs.

Tolerances:
  * the loader's ``ext_rois``/``ext_valid`` against JAX's
    ``DetectionLoader`` on the same roidb, seed and pkl: bitwise, in train
    batches (flips, a portrait record, more proposals than
    ``num_proposals`` with tied scores, fewer, none, a quarantined record)
    and eval batches;
  * ``forward_train`` in Fast R-CNN mode (``rpn.loss_weight`` 0) and in
    joint mode, given JAX's draws: loss and metrics at
    ``test_torch_train.py``'s ``TOL``, the accuracies exactly; gradients
    at that file's per-leaf tolerances; the RPN's are ``None`` in the port
    and zero in JAX in Fast R-CNN mode;
  * ``forward_inference`` on external rois: ``match_fraction`` >= 0.9 per
    image (same class, IoU >= 0.9, score within 1e-3), as
    ``test_torch_inference.py`` holds the end-to-end path;
  * ``dump_proposals`` of both packages on the same weights and images:
    the same image ids; per image at least 90% of JAX's proposals found
    in the port's (IoU >= 0.9, score within 1e-3: the convolutions sum in
    another order, which can reorder near-tied candidates); each
    package's pkl loads with the other's ``load_proposals``;
  * ``build_all(extra_freeze=...)``: the trainable set equals JAX's
    ``frozen_mask`` under the bridge's name map, for each phase of the
    alternate schedule, and one optimizer step equals the optax chain's
    within 1e-6, frozen leaves bitwise unchanged.
"""

from __future__ import annotations

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.cli import eval_cli as jax_eval_cli
from mx_rcnn_tpu.config import ScheduleConfig as JaxSchedule
from mx_rcnn_tpu.config import apply_overrides as jax_overrides
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data import loader as jax_loader_mod
from mx_rcnn_tpu.data.loader import DetectionLoader as JaxLoader
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.detection import Batch as JaxBatch
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu.detection import graph as JG
from mx_rcnn_tpu.train.loop import FREEZE_PREFIXES as JAX_FREEZE
from mx_rcnn_tpu.train.optim import frozen_mask as jax_frozen_mask
from mx_rcnn_tpu.train.optim import make_optimizer
from mx_rcnn_tpu.train.state import TrainState as JaxTrainState
from mx_rcnn_tpu_torch.cli import alternate_cli
from mx_rcnn_tpu_torch.cli import eval_cli
from mx_rcnn_tpu_torch.config import apply_overrides, get_config
from mx_rcnn_tpu_torch.data import datasets as TD
from mx_rcnn_tpu_torch.data import loader as TL
from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
from mx_rcnn_tpu_torch.data.loader import DetectionLoader, assemble, eval_batches, load_proposals
from mx_rcnn_tpu_torch.detection import graph as TG
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction, unletterbox_detections
from mx_rcnn_tpu_torch.train.loop import build_all, scale_schedule_steps
from mx_rcnn_tpu_torch.weights import init_variables, to_jax_variables
from test_torch_loader_train import WIDE, _cfgs, _records
from test_torch_train import METRICS, STATS, TOL, _leaves, _uniforms

torch.set_num_threads(2)

# Landscape and portrait records, of which 3 gets an inverted box.
SIZES = [(48, 64), (64, 48), (40, 80), (72, 40), (64, 64), (50, 60), (60, 50)]
COUNTS = [25, 10, 4, 0, 13, 7, 31]      # proposals a record, around NUM = 10
NUM = 10


def _proposals(sizes, counts, seed=0, ids=None):
    """image_id -> boxes partly outside the image and scores on a coarse
    grid (ties the stable sort must keep in file order)."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, ((h, w), n) in enumerate(zip(sizes, counts)):
        xy = rng.uniform(-6, [w, h], (n, 2))
        wh = rng.uniform(1, [w / 2, h / 2], (n, 2))
        out[str(i) if ids is None else ids[i]] = {
            "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
            "scores": (rng.randint(0, 5, n) / 4).astype(np.float32)}
    return out


def _quarantined_records():
    ours, theirs = _records(SIZES, seed=4)
    for recs in (ours, theirs):
        recs[3].boxes = recs[3].boxes[:, [2, 1, 0, 3]].copy()
    return ours, theirs


# ---------------------------------------------------------------------------
# The loader


def test_loader_ext_rois_match_jax_bitwise(tmp_path):
    ours, theirs = _quarantined_records()
    path = str(tmp_path / "props.pkl")
    with open(path, "wb") as f:
        pickle.dump(_proposals(SIZES, COUNTS), f)
    props, jprops = load_proposals(path), jax_loader_mod.load_proposals(path)
    data, jdata = _cfgs(image_size=WIDE, flip=True)
    port = DetectionLoader(ours, data, 2, "cpu", seed=1, io_retries=0, proposals=props,
                           num_proposals=NUM)
    ref = JaxLoader(theirs, jdata, batch_size=2, train=True, seed=1, prefetch=False,
                    num_workers=0, service_workers=0, io_retries=0, proposals=jprops,
                    num_proposals=NUM)
    def plain(specs):
        return [([int(j) for j in i], [bool(x) for x in fl]) for i, fl in specs]

    specs = plain(ref._batch_index_specs(epochs=3))
    assert specs == plain(port._batch_index_specs(epochs=3))
    seen = set()
    for idxs, flips in specs:
        got, want = port._assemble(idxs, flips), ref._assemble_rows((idxs, flips))
        assert got.ext_rois.dtype == torch.float32 and got.ext_valid.dtype == torch.bool
        np.testing.assert_array_equal(got.ext_rois.numpy(), want.ext_rois)
        np.testing.assert_array_equal(got.ext_valid.numpy(), want.ext_valid)
        np.testing.assert_array_equal(got.image_hw.numpy(), want.image_hw)
        seen.update((j, f) for j, f in zip(idxs, flips))
    # Flipped and unflipped, portrait, and the quarantined record were all met.
    assert {f for _, f in seen} == {True, False}
    assert any(ours[j].aspect < 1 for j, _ in seen) and any(j == 3 for j, _ in seen)
    # Padding, truncation and a record with none.
    b = port._assemble([2, 0], [False, True])
    assert b.ext_valid.sum(1).tolist() == [4, NUM] and not b.ext_rois[0, 4:].any()
    b = port._assemble([3], [True])
    assert not b.ext_valid.any() and not b.ext_rois.any()

    jeval = JaxLoader(theirs, jdata, batch_size=3, train=False, prefetch=False, num_workers=0,
                      service_workers=0, proposals=jprops, num_proposals=NUM)
    pairs = list(zip(eval_batches(ours, data, 3, "cpu", props, NUM), jeval, strict=True))
    for (got, recs), (want, jrecs) in pairs:
        assert [r.image_id for r in recs] == [r.image_id for r in jrecs]
        np.testing.assert_array_equal(got.ext_rois.numpy(), want.ext_rois)
        np.testing.assert_array_equal(got.ext_valid.numpy(), want.ext_valid)


def test_missing_proposals_fail_fast(tmp_path):
    ours, _ = _records(SIZES[:3])
    data, _ = _cfgs(image_size=WIDE)
    props = _proposals(SIZES[:2], COUNTS[:2])
    with pytest.raises(ValueError, match="no proposals"):
        DetectionLoader(ours, data, 1, "cpu", proposals=props, num_proposals=NUM)
    with pytest.raises(ValueError, match="no proposals"):
        next(eval_batches(ours, data, 1, "cpu", props, NUM))
    bad = str(tmp_path / "bad.pkl")
    with open(bad, "wb") as f:
        pickle.dump({"0": {"boxes": np.zeros((3, 5)), "scores": np.zeros(3)}}, f)
    for load in (load_proposals, jax_loader_mod.load_proposals):
        with pytest.raises(ValueError, match="boxes"):
            load(bad)


# ---------------------------------------------------------------------------
# The graph


def _tiny(overrides=()):
    cfg = apply_overrides(get_config("tiny_synthetic"), list(overrides))
    jcfg = jax_overrides(jax_get_config("tiny_synthetic"), list(overrides))
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    return cfg, jcfg, sd


def _ext_batch(cfg, r=48):
    ds = SyntheticDataset(image_hw=(128, 128), num_classes=5)
    recs = [ds.record(0), ds.record(1)]
    # Jittered copies of the gt, then noise boxes, in original coordinates.
    rng = np.random.RandomState(3)
    props = {}
    for rec in recs:
        jit = np.repeat(rec.boxes, 8, 0) + rng.uniform(-6, 6, (8 * len(rec.boxes), 4))
        xy = rng.uniform(0, 90, (r, 2))
        noise = np.concatenate([xy, xy + rng.uniform(8, 40, (r, 2))], 1)
        boxes = np.concatenate([jit, noise]).astype(np.float32)
        props[rec.image_id] = {"boxes": boxes,
                               "scores": rng.uniform(0, 1, len(boxes)).astype(np.float32)}
    return assemble(recs, cfg.data, "cpu", flips=[False, True], proposals=props,
                    num_proposals=r)


def _jax_batch(batch):
    return JaxBatch(*(jnp.asarray(x.numpy()) for x in batch[:5]),
                    ext_rois=jnp.asarray(batch.ext_rois.numpy()),
                    ext_valid=jnp.asarray(batch.ext_valid.numpy()))


@pytest.mark.parametrize("mode", ["fast_rcnn", "joint"])
def test_forward_train_with_ext_rois_matches_jax(mode):
    cfg, jcfg, sd = _tiny(["model.rpn.loss_weight=0.0"] if mode == "fast_rcnn" else [])
    batch = _ext_batch(cfg)
    model = TwoStageDetector(cfg.model, device="cpu")
    model.load_state_dict(sd)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(sd))
    keys = (jax.random.split(jax.random.PRNGKey(5), 2), jax.random.split(jax.random.PRNGKey(6), 2))
    jmodel = JaxDetector(cfg=jcfg.model)
    jbatch = _jax_batch(batch)

    def loss(params):
        return JG.forward_train(jmodel, {"params": params, "constants": variables["constants"]},
                                None, jbatch, pixel_stats=STATS, rngs=keys)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    n_anchors = sum(3 * (128 >> l) ** 2 for l in range(2, 7))
    n_rows = batch.ext_rois.shape[1] + cfg.data.max_gt_boxes
    draws = TG.Draws(*_uniforms(keys[0], n_anchors), *_uniforms(keys[1], n_rows))
    total, tm = TG.forward_train(model, batch, draws, STATS)
    total.backward()

    tm = {k: float(v.detach()) for k, v in tm.items()}
    for k in METRICS:
        np.testing.assert_allclose(tm[k], float(jm[k]), err_msg=k, **TOL)
    assert tm["RPNAcc"] == float(jm["RPNAcc"]) and tm["RCNNAcc"] == float(jm["RCNNAcc"])
    assert tm["RCNNL1Loss"] > 0
    rpn_grads = [p.grad for n, p in model.named_parameters() if n.startswith("rpn_head.")]
    if mode == "fast_rcnn":
        assert tm["RPNLogLoss"] == tm["RPNL1Loss"] == tm["RPNAcc"] == 0.0
        assert all(g is None for g in rpn_grads)
        assert not any(np.asarray(g).any() for g in jax.tree_util.tree_leaves(jg["rpn"]))
    else:
        assert tm["RPNLogLoss"] > 0 and all(g is not None for g in rpn_grads)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    want, got = _leaves(jg), _leaves(to_jax_variables(grads)["params"])
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if "backbone" in k:
            assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w) + 1e-12, k
        else:
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, k


def test_sample_draws_do_not_depend_on_the_rpn():
    """A generator gives Fast R-CNN and joint mode the same sample draws:
    the anchor draws are taken in both, so the R-CNN terms agree; and
    what is sampled comes from the external rois."""
    cfg, _, sd = _tiny()
    batch = _ext_batch(cfg)
    model = TwoStageDetector(cfg.model, device="cpu")
    model.load_state_dict(sd)
    out = {}
    for weight in ("0.0", "1.0"):
        model.cfg = apply_overrides(cfg, [f"model.rpn.loss_weight={weight}"]).model
        with torch.no_grad():
            out[weight] = TG.forward_train(model, batch, torch.Generator().manual_seed(9),
                                           STATS)[1]
    for k in ("RCNNAcc", "RCNNLogLoss", "RCNNL1Loss"):
        assert float(out["0.0"][k]) == float(out["1.0"][k]), k
    # The rois are sampled from the external set: masking it out (the gt
    # alone left) changes the loss.
    with torch.no_grad():
        empty = batch._replace(ext_valid=torch.zeros_like(batch.ext_valid))
        alone = TG.forward_train(model, empty, torch.Generator().manual_seed(9), STATS)[1]
    assert float(alone["RCNNLogLoss"]) != float(out["1.0"]["RCNNLogLoss"])
    with pytest.raises(ValueError, match="ext_valid"):
        TG.forward_train(model, batch._replace(ext_valid=None), torch.Generator(), STATS)


def test_forward_inference_on_ext_rois_matches_jax():
    cfg, jcfg, sd = _tiny()
    sd["box_head.cls_score.bias"][1:3] = 3.0      # detections above the threshold
    batch = _ext_batch(cfg, r=64)
    model = TwoStageDetector(cfg.model, device="cpu")
    model.load_state_dict(sd)
    model.eval()
    jmodel = JaxDetector(cfg=jcfg.model)
    want = jax.jit(lambda v, b: JG.forward_inference(jmodel, v, b, pixel_stats=STATS))(
        to_jax_variables(sd), _jax_batch(batch))
    with torch.inference_mode():
        got = TG.forward_inference(model, batch, STATS)
        with pytest.raises(ValueError, match="ext_valid"):
            TG.forward_inference(model, batch._replace(ext_valid=None), STATS)
    for i in range(2):
        ref = unletterbox_detections(*(np.asarray(x[i]) for x in want[:4]), 1.0, 128, 128)
        out = unletterbox_detections(*(x[i].numpy() for x in got[:4]), 1.0, 128, 128)
        assert len(ref["scores"]) > 10
        assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9
        # Every detection decodes from an external roi: none from the RPN.
        hw = batch.image_hw[i].numpy()
        assert (out["boxes"][:, 2] <= hw[1]).all() and (out["boxes"][:, 3] <= hw[0]).all()


# ---------------------------------------------------------------------------
# The proposal dump


class _Roidb:
    def __init__(self, records):
        self.records = records

    def roidb(self):
        return list(self.records)


def test_dump_proposals_matches_jax(tmp_path, monkeypatch):
    over = ["model.test.per_device_batch=3"]
    cfg, jcfg, sd = _tiny(over)
    ds = SyntheticDataset(image_hw=(128, 128), num_classes=5, seed=2)
    ours = [ds.record(i) for i in range(7)]
    jrecs = [JaxRecord(r.image_id, "", r.height, r.width, r.boxes, r.gt_classes,
                                      image_array=r.image_array) for r in ours]
    monkeypatch.setattr(TD, "build_dataset", lambda *a, **k: _Roidb(ours))
    import mx_rcnn_tpu.data as jax_data
    monkeypatch.setattr(jax_data, "build_dataset", lambda *a, **k: _Roidb(jrecs))

    _, _, state, _, _ = build_all(cfg, "cpu", variables=sd)
    variables = to_jax_variables(sd)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           model_state={"constants": variables["constants"]}, opt_state=None,
                           rng=None)
    paths = {k: str(tmp_path / f"{k}.pkl") for k in ("port", "jax")}
    got = eval_cli.dump_proposals(cfg, paths["port"], state=state, device="cpu")
    want = jax_eval_cli.dump_proposals(jcfg, paths["jax"], state=jstate)
    assert sorted(got) == sorted(want) == sorted(r.image_id for r in ours)
    for key in want:
        g, w = got[key], want[key]
        assert g["boxes"].dtype == np.float32 and g["scores"].dtype == np.float32
        assert len(g["scores"]) == cfg.model.rpn.train_post_nms_top_n
        ref = {"boxes": w["boxes"], "scores": w["scores"], "classes": np.zeros(len(w["scores"]))}
        out = {"boxes": g["boxes"], "scores": g["scores"], "classes": np.zeros(len(g["scores"]))}
        assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9, key
    # Each package reads the other's pkl.
    for a, b in ((load_proposals(paths["jax"]), want), (jax_loader_mod.load_proposals(paths["port"]), got)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k]["boxes"], b[k]["boxes"])
    # The val split takes the test counts.
    val = eval_cli.dump_proposals(cfg, str(tmp_path / "val.pkl"), state=state, device="cpu",
                                  train_split=False)
    assert max(len(v["scores"]) for v in val.values()) <= cfg.model.rpn.test_post_nms_top_n


# ---------------------------------------------------------------------------
# Freezing


def _jax_trainable(params, prefixes):
    mask = jax_frozen_mask(params, prefixes)
    return {k for k, v in _leaves(mask).items() if v}


@pytest.mark.parametrize("config", ["tiny_synthetic", "vgg16_voc07"])
def test_extra_freeze_trainable_sets_match_jax(config):
    cfg = apply_overrides(get_config(config), ["model.rcnn.hidden_dim=16"])
    _, _, state, _, _ = build_all(cfg, "cpu")
    sd = state.model.state_dict()
    params = to_jax_variables(dict(state.model.named_parameters()))["params"]
    base = JAX_FREEZE.get(cfg.model.backbone.name, ()) if cfg.model.backbone.freeze_stages else ()
    for _, _, _, freeze, _ in alternate_cli.PHASES:
        _, _, state, _, _ = build_all(cfg, "cpu", variables=sd, extra_freeze=freeze)
        trainable = {n: p.requires_grad for n, p in state.model.named_parameters()}
        flags = {n: torch.tensor(float(t)).expand(p.shape)
                 for (n, t), p in zip(trainable.items(), state.model.parameters())}
        got = {k for k, v in _leaves(to_jax_variables(flags)["params"]).items() if v.all()}
        assert got == _jax_trainable(params, tuple(base) + freeze), freeze
        assert set(state.optimizer.names) == {n for n, t in trainable.items() if t}
        # "rpn" is the JAX module path of the port's rpn_head.
        assert any(n.startswith("rpn_head.") for n, t in trainable.items()) and \
            all(not t for n, t in trainable.items() if n.startswith("rpn_head.")) == \
            ("rpn" in freeze)


def test_frozen_step_matches_optax():
    """One step with the rcnn2 freeze set (backbone, fpn, rpn): the box
    head moves as optax moves it, every frozen leaf stays bitwise, weight
    decay included."""
    freeze = alternate_cli.PHASES[3][3]
    cfg = get_config("tiny_synthetic")
    model, opt, state, _, global_batch = build_all(cfg, "cpu", extra_freeze=freeze)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(4)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in model.named_parameters()}
    opt.apply([grads[n] for n in opt.names])

    sched = scale_schedule_steps(cfg.train.schedule, global_batch)
    jtc = dataclasses.replace(jax_get_config("tiny_synthetic").train,
                              schedule=JaxSchedule(**dataclasses.asdict(sched)))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(start)["params"])
    tx, _ = make_optimizer(jtc, params, lr_scale=global_batch / (sched.reference_batch or 16),
                           freeze_prefixes=freeze)
    jgrads = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(grads)["params"])
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params), params)
    want = _leaves(optax.apply_updates(params, updates))
    got = _leaves(to_jax_variables({n: p.detach() for n, p in model.named_parameters()})["params"])
    before = _leaves(to_jax_variables(start)["params"])
    trainable = _jax_trainable(params, freeze)
    assert trainable and all("box_head" in k for k in trainable)
    for k, w in want.items():
        if k in trainable:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
            assert not np.array_equal(got[k], before[k]), k
        else:
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(w, before[k], err_msg=k)
