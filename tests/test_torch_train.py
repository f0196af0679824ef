"""The train step on ``tiny_synthetic`` against the JAX package: same
weights (carried by ``weights.py``), same uint8 batch (the port's loader
over the synthetic set), same draws (made from the JAX keys that
``forward_train(..., rngs=...)`` takes, and handed to the port).

Tolerances:
  * loss and the six metrics: rtol 2e-6, atol 1e-7 (float32 sums in
    another order); the two accuracies exactly.  Proposals and samples
    agree, so the R-CNN terms are held as tightly as the RPN terms.
  * parameter gradients against ``jax.grad``, per leaf: the heads and the
    FPN within 1e-5 of the leaf's largest magnitude; backbone leaves
    within 5e-3 in norm (``|g - g_jax| <= 5e-3 |g_jax|``): backprop through
    a random-weight ResNet-50 in float32 cancels heavily, and the two
    frameworks' convolutions sum in different orders (measured worst
    2e-3).
  * the optimizer against the optax chain of ``make_optimizer`` over 3
    steps (warmup, a decay boundary, one clipped step, frozen prefixes):
    parameters within 1e-6, frozen ones bitwise unchanged, lr bitwise.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.config import ScheduleConfig as JaxSchedule
from mx_rcnn_tpu.config import TrainConfig as JaxTrain
from mx_rcnn_tpu.config import apply_overrides as jax_overrides
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mx_rcnn_tpu.detection import Batch as JaxBatch
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu.detection.graph import forward_train as jax_forward_train
from mx_rcnn_tpu.train.loop import FREEZE_PREFIXES as JAX_FREEZE
from mx_rcnn_tpu.train.optim import make_optimizer
from mx_rcnn_tpu_torch.cli import train_cli
from mx_rcnn_tpu_torch.config import ScheduleConfig, TrainConfig, apply_overrides, get_config
from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
from mx_rcnn_tpu_torch.data.loader import assemble
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.detection.graph import Draws, forward_train
from mx_rcnn_tpu_torch.train.loop import FREEZE_PREFIXES, build_all, train
from mx_rcnn_tpu_torch.train.optim import SGDMomentum, frozen_mask, make_schedule
from mx_rcnn_tpu_torch.weights import from_jax_variables, init_variables, to_jax_variables

torch.set_num_threads(2)

TOL = dict(rtol=2e-6, atol=1e-7)
STATS = (get_config("tiny_synthetic").data.pixel_mean, get_config("tiny_synthetic").data.pixel_std)
METRICS = ("RPNAcc", "RPNLogLoss", "RPNL1Loss", "RCNNAcc", "RCNNLogLoss", "RCNNL1Loss", "loss")


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _uniforms(keys, n):
    def one(k):
        k_fg, k_bg = jax.random.split(k)
        return jax.random.uniform(k_fg, (n,)), jax.random.uniform(k_bg, (n,))
    fg, bg = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(fg)), torch.from_numpy(np.array(bg))


def _run_both(overrides):
    """forward_train and its gradients in both packages; -> (port metrics,
    port grads as a JAX tree, JAX metrics, JAX grads)."""
    cfg = apply_overrides(get_config("tiny_synthetic"), overrides)
    jcfg = jax_overrides(jax_get_config("tiny_synthetic"), overrides)
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    ds = SyntheticDataset(image_hw=(128, 128), num_classes=5)
    batch = assemble([ds.record(0), ds.record(1)], cfg.data, "cpu")
    model = TwoStageDetector(cfg.model, device="cpu")
    model.load_state_dict(sd)

    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(sd))
    jbatch = JaxBatch(*(jnp.asarray(x.numpy()) for x in batch[:5]))
    keys = (jax.random.split(jax.random.PRNGKey(5), 2), jax.random.split(jax.random.PRNGKey(6), 2))
    jmodel = JaxDetector(cfg=jcfg.model)

    def loss(params):
        return jax_forward_train(jmodel, {"params": params, "constants": variables["constants"]},
                                 None, jbatch, pixel_stats=STATS, rngs=keys)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    n_anchors = sum(3 * (128 >> l) ** 2 for l in range(2, 7))
    n_rows = cfg.model.rpn.train_post_nms_top_n + cfg.data.max_gt_boxes
    draws = Draws(*_uniforms(keys[0], n_anchors), *_uniforms(keys[1], n_rows))
    total, tm = forward_train(model, batch, draws, STATS)
    total.backward()
    tg = to_jax_variables({n: p.grad for n, p in model.named_parameters()})["params"]
    return tm, tg, jm, jg


def _check(tm, tg, jm, jg):
    tm = {k: float(v.detach()) for k, v in tm.items()}
    for k in METRICS:
        np.testing.assert_allclose(tm[k], float(jm[k]), err_msg=k, **TOL)
    assert tm["RPNAcc"] == float(jm["RPNAcc"])
    assert tm["RCNNAcc"] == float(jm["RCNNAcc"])
    want, got = _leaves(jg), _leaves(tg)
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if "backbone" in k:
            assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w) + 1e-12, k
        else:
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, k


@pytest.mark.parametrize("loss_impl", ["dense", "compact"])
def test_forward_train_and_grads_match_jax(loss_impl):
    tm, tg, jm, jg = _run_both([f"model.rpn.loss_impl={loss_impl}"])
    _check(tm, tg, jm, jg)
    assert float(tm["RCNNL1Loss"]) > 0 and np.abs(_leaves(tg)["['box_head']['fc6']['kernel']"]).max() > 0


def test_rpn_only_grads_match_jax():
    """With the R-CNN terms weighted 0 every gradient comes from the RPN
    losses: the RPN head, the FPN and the backbone through P2-P6."""
    tm, tg, jm, jg = _run_both(["model.rcnn.loss_weight=0.0"])
    _check(tm, tg, jm, jg)
    leaves = _leaves(tg)
    assert np.abs(leaves["['rpn']['conv']['kernel']"]).max() > 0
    assert np.abs(leaves["['box_head']['fc6']['kernel']"]).max() == 0


def test_forward_train_refuses_masks_and_external_rois():
    cfg = get_config("tiny_synthetic")
    model = TwoStageDetector(cfg.model, device="cpu")
    ds = SyntheticDataset(image_hw=(128, 128))
    batch = assemble([ds.record(0)], cfg.data, "cpu")
    jbatch = JaxBatch(*batch[:5], ext_rois=torch.zeros(1, 4, 4), ext_valid=torch.ones(1, 4))
    with pytest.raises(NotImplementedError, match="ext_rois"):
        forward_train(model, jbatch, torch.Generator(), STATS)


def test_synthetic_records_match_jax():
    ours = SyntheticDataset(image_hw=(96, 128), num_classes=7, seed=3)
    theirs = JaxSynthetic(num_images=4, image_hw=(96, 128), num_classes=7, seed=3,
                          dtype="uint8").roidb()
    for i, rec in enumerate(theirs):
        got = ours.record(i)
        assert got.image_array.dtype == np.uint8
        np.testing.assert_array_equal(got.image_array, rec.image_array)
        np.testing.assert_array_equal(got.boxes, rec.boxes)
        np.testing.assert_array_equal(got.gt_classes, rec.gt_classes)


def test_loader_letterboxes_uint8_and_pads_gt():
    cfg = dataclasses.replace(get_config("tiny_synthetic").data, image_size=(64, 96),
                              short_side=64, max_side=90, max_gt_boxes=6)
    ds = SyntheticDataset(image_hw=(64, 96), max_objects=4)
    recs = [ds.record(0), ds.record(1)]
    batch = assemble(recs, cfg, "cpu")
    assert batch.images.dtype == torch.uint8 and batch.images.shape == (2, 64, 96, 3)
    scale = 90 / 96
    np.testing.assert_array_equal(batch.image_hw.numpy(), [[60, 90], [60, 90]])
    assert (batch.images[:, 60:] == 0).all() and (batch.images[:, :, 90:] == 0).all()
    for i, rec in enumerate(recs):
        n = len(rec.boxes)
        assert batch.gt_valid[i].sum() == n and not batch.gt_valid[i, n:].any()
        np.testing.assert_array_equal(batch.gt_boxes[i, :n].numpy(), rec.boxes * np.float32(scale))
        np.testing.assert_array_equal(batch.gt_classes[i, :n].numpy(), rec.gt_classes)
    with pytest.raises(ValueError):
        assemble([dataclasses.replace(recs[0], image_array=recs[0].image_array.astype(np.float32))],
                 cfg, "cpu")


def test_frozen_mask_anchors_prefixes():
    names = ["backbone.conv1.weight", "backbone.layer1_block0.conv1.weight",
             "backbone.layer10_block0.conv1.weight", "backbone.layer2_block0.conv1.weight",
             "rpn_head.conv.weight", "box_head.fc6.bias"]
    got = frozen_mask(names, FREEZE_PREFIXES["resnet50"])
    assert [got[n] for n in names] == [False, False, False, True, True, True]
    assert FREEZE_PREFIXES == {k: JAX_FREEZE[k] for k in FREEZE_PREFIXES}


def test_optimizer_matches_optax():
    sched = ScheduleConfig(base_lr=0.02, warmup_steps=2, decay_steps=(2,), factor=0.1,
                           total_steps=10, reference_batch=0)
    tc = TrainConfig(grad_clip=30.0, schedule=sched)
    jtc = JaxTrain(grad_clip=30.0, schedule=JaxSchedule(**dataclasses.asdict(sched)))
    cfg = get_config("tiny_synthetic").model
    sd = init_variables(cfg, torch.Generator().manual_seed(1))
    model = TwoStageDetector(cfg, device="cpu")
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    trainable = frozen_mask(params, FREEZE_PREFIXES["resnet50"])
    opt = SGDMomentum({n: p for n, p in params.items() if trainable[n]}, tc,
                      make_schedule(sched, 2 / 16))
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(sd)["params"])
    tx, jsched = make_optimizer(jtc, jparams, lr_scale=2 / 16,
                                freeze_prefixes=JAX_FREEZE["resnet50"])
    state = tx.init(jparams)
    rng = np.random.RandomState(0)
    for step in range(3):
        grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)
                                     * (0.05 if step != 1 else 1.0))
                 for n, p in params.items()}
        jgrads = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(grads)["params"])
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = opt.apply([grads[n] for n in opt.names])
        assert np.float32(lr) == np.asarray(jsched(step)), step
    assert opt.step == 3
    want = _leaves(jparams)
    got = _leaves(to_jax_variables({n: p.detach() for n, p in params.items()})["params"])
    start = _leaves(to_jax_variables(sd)["params"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    frozen = [k for k in start if k.startswith("['backbone']['layer1_block")
              or k == "['backbone']['conv1']['kernel']"]
    assert frozen and all(np.array_equal(got[k], start[k]) for k in frozen)


def _frozen_and_buffers(model):
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    return frozen, {n: b.clone() for n, b in model.named_buffers()}


def test_train_on_cpu_two_steps(capsys):
    cfg = apply_overrides(get_config("tiny_synthetic"),
                          ["model.backbone.freeze_stages=2", "model.rpn.loss_impl=compact",
                           "train.log_every=1"])
    model, _, _, _, _ = build_all(cfg, device="cpu")
    frozen, buffers = _frozen_and_buffers(model)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    assert frozen and all(n.startswith(("backbone.conv1", "backbone.layer1_")) for n in frozen)

    lines = []
    state = train(cfg, steps=2, device="cpu", log=lines.append)
    assert state.step == 2 and state.optimizer.step == 2 and len(lines) == 2
    import json

    for line in lines:
        m = json.loads(line)
        assert all(np.isfinite(m[k]) for k in METRICS) and m["nonfinite"] == 0.0
    after = dict(state.model.named_parameters())
    assert all(torch.equal(after[n], v) for n, v in frozen.items())
    assert all(torch.equal(b, buffers[n]) for n, b in state.model.named_buffers())
    assert any(not torch.equal(after[n], v) for n, v in trainable.items())
    # The trained weights round-trip through the JAX bridge bitwise.
    sd = state.model.state_dict()
    back = from_jax_variables(to_jax_variables(sd))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_train_cli_on_cpu(capsys, tmp_path):
    result = train_cli.main(["--config", "tiny_synthetic", "--steps", "2", "--device", "cpu",
                             "--seed", "4", "--set", "model.rcnn.roi_align_bwd_impl=xla",
                             "--set", "train.log_every=1", "--no-eval",
                             "--workdir", str(tmp_path)])
    assert result == {"final_step": 2}
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and '"step": 2' in out[-1]
    assert sorted(os.listdir(tmp_path / "tiny_synthetic" / "ckpt")) == [
        "0", "2", "manifest-0.json", "manifest-2.json"]


def test_train_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_config("tiny_synthetic"), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", "tiny_synthetic", "--steps", "1"])
