"""The single-level C4 recipe (``r50_coco``, ``r101_coco``,
``vgg16_voc07``) and the ``r101_fpn_coco`` preset against the JAX
package, at small sizes (64-128 px canvases, ``hidden_dim`` 64, pre- and
post-NMS top-n in the hundreds; the VGG trunk keeps its real widths).

Tolerances:
  * presets: every field the port shares with JAX's ``get_config`` equal;
  * trunks and RPN head (float32): within 1e-4 of each tensor's largest
    magnitude, as ``test_torch_models.py`` (the convolutions sum in
    another order; the JAX ResNet runs its TPU layout rewrites);
  * parameter trees: the port's keys and shapes are the JAX tree's,
    ``layer4`` of the C4 ResNets included, and the bridge round-trips
    them bitwise;
  * ROIAlign: the port's single-level ``roi_align`` against JAX's within
    1e-5 (float32 sums of 16 taps, as ``test_torch_roi_align.py``), and
    the plain one-level ``multilevel_roi_align``, B1's and B2's plain
    version on the C4 path, bitwise equal to ``roi_align`` in float32 and
    bfloat16;
  * proposals: keep, index and roi results bitwise in all three middles,
    against JAX's dense chain and against its own middle (the Pallas NMS
    in interpret mode; the fused middle in interpret mode on inputs whose
    decode is exact, see ``test_torch_middle.py``);
  * ``forward_inference`` end to end in float32, both ``nms_mode``s:
    ``match_fraction`` >= 0.9 per image, as ``test_torch_inference.py``;
  * ``forward_train``: loss and metrics and gradients at
    ``test_torch_train.py``'s tolerances; ``layer4``, which no output
    reads, gets a zero gradient in both and after two steps equals the
    optax chain's weight-decay and momentum update bitwise;
  * checkpoints: a C4 state saved by the port passes the JAX
    ``verify_manifest``; the VOC 2007 metric at the VGG canvas equals
    JAX's bit for bit.
"""

from __future__ import annotations

import importlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.config import ScheduleConfig as JaxSchedule
from mx_rcnn_tpu.config import apply_overrides as jax_overrides
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.data.roidb import RoiRecord as JaxRecord
from mx_rcnn_tpu.detection import Batch as JaxBatch
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu.detection import graph as JG
from mx_rcnn_tpu.evalutil import evaluate_detections as jax_evaluate_detections
from mx_rcnn_tpu.ops.proposals import generate_proposals as jax_generate_proposals
from mx_rcnn_tpu.ops.roi_align import roi_align as jax_roi_align
from mx_rcnn_tpu.train.checkpoint import verify_manifest as jax_verify_manifest
from mx_rcnn_tpu.train.loop import FREEZE_PREFIXES as JAX_FREEZE
from mx_rcnn_tpu.train.optim import make_optimizer
from mx_rcnn_tpu_torch.cli.eval_cli import default_use_07_metric
from mx_rcnn_tpu_torch.config import apply_overrides, available_configs, get_config
from mx_rcnn_tpu_torch.data.batch import Batch
from mx_rcnn_tpu_torch.data.datasets import VOC_CLASSES, SyntheticDataset
from mx_rcnn_tpu_torch.data.loader import assemble
from mx_rcnn_tpu_torch.data.roidb import RoiRecord
from mx_rcnn_tpu_torch.detection import graph as TG
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
# The module (the package exports the function of the same name).
TPE = importlib.import_module("mx_rcnn_tpu_torch.evalutil.pred_eval")
from mx_rcnn_tpu_torch.evalutil.postprocess import match_fraction, unletterbox_detections
from mx_rcnn_tpu_torch.ops.proposals import generate_proposals
from mx_rcnn_tpu_torch.ops.roi_align import multilevel_roi_align, roi_align
from mx_rcnn_tpu_torch.train import checkpoint as C
from mx_rcnn_tpu_torch.train.loop import build_all, scale_schedule_steps
from mx_rcnn_tpu_torch.weights import from_jax_variables, init_variables, to_jax_variables

torch.set_num_threads(2)

RTOL = 1e-4           # of each tensor's max |value|: f32 conv sums in another order
ROI_ATOL = 1e-5       # float32 sums of 4 taps x 4 samples
TRAIN_TOL = dict(rtol=2e-6, atol=1e-7)
METRICS = ("RPNAcc", "RPNLogLoss", "RPNL1Loss", "RCNNAcc", "RCNNLogLoss", "RCNNL1Loss", "loss")
C4 = ("r50_coco", "r101_coco", "vgg16_voc07")
# Small shapes, float32, and a narrow box head; the presets' other fields.
SMALL = ["model.precision.policy=float32", "model.backbone.dtype=float32",
         "model.rcnn.hidden_dim=64", "model.rpn.train_pre_nms_top_n=300",
         "model.rpn.train_post_nms_top_n=100", "model.rpn.test_pre_nms_top_n=300",
         "model.rpn.test_post_nms_top_n=100", "model.rpn.batch_size=64",
         "model.rcnn.roi_batch_size=32", "data.image_size=96,128", "data.short_side=96",
         "data.max_side=128", "data.max_gt_boxes=8"]
HW = np.array([[96.0, 128.0], [80.0, 112.0]], np.float32)
# Train steps on a canvas that holds the C4 anchors (128-512 px), so the
# RPN has labelled anchors.
TRAIN_CANVAS = ["data.image_size=192,256", "data.short_side=192", "data.max_side=256"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(name, over=()):
    over = [*SMALL, *over]
    return apply_overrides(get_config(name), over), jax_overrides(jax_get_config(name), over)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


# ---------------------------------------------------------------------------
# Presets


def _fields(ours, theirs, path=""):
    for f in dataclasses.fields(ours):
        a = getattr(ours, f.name)
        assert hasattr(theirs, f.name), f"JAX has no {path}{f.name}"
        b = getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            yield from _fields(a, b, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}", a, b


@pytest.mark.parametrize("name", [*C4, "r101_fpn_coco", "mask_r50_fpn_coco"])
def test_preset_equals_jax_field_by_field(name):
    assert name in available_configs()
    pairs = list(_fields(get_config(name), jax_get_config(name)))
    assert len(pairs) > 60
    assert [(p, a, b) for p, a, b in pairs if a != b] == []


# ---------------------------------------------------------------------------
# Trunks, heads and the parameter tree


@pytest.fixture(scope="module", params=["r50_coco", "vgg16_voc07"])
def models(request):
    cfg, jcfg = _configs(request.param)
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    sd["box_head.cls_score.bias"][1:4] = 4.0   # detections above the threshold
    port = TwoStageDetector(cfg.model, device="cpu")
    port.load_state_dict(sd)
    port.eval()
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, port=port, jmodel=JaxDetector(cfg=jcfg.model),
                variables=to_jax_variables(sd))


def test_trunk_and_rpn_head_match_flax(models):
    """VGG-16 (conv5_3) and ResNet-50 with ``out_levels=(4,)`` (C4) at
    64x64, then the RPN head on them."""
    port, jmodel, variables = models["port"], models["jmodel"], models["variables"]
    images = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        feats = port.features(torch.from_numpy(images))
        rpn = port.rpn(feats)
    jfeats = jmodel.apply(variables, jnp.asarray(images), method="features")
    channels = 512 if models["cfg"].model.backbone.name == "vgg16" else 1024
    assert sorted(feats) == sorted(jfeats) == [4] and feats[4].shape == (2, 4, 4, channels)
    assert feats[4].is_contiguous()
    _close(feats[4].numpy(), jfeats[4])
    jrpn = jmodel.apply(variables, jfeats, method="rpn")
    for got, want in zip(rpn[4], jrpn[4]):
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", C4)
def test_parameter_tree_is_the_jax_tree(name):
    """Keys and shapes of the port's state_dict through the bridge equal
    the JAX detector's variables (``jax.eval_shape`` of its ``init``),
    ``layer4`` of the C4 ResNets and VGG's biases and fc6 included, and
    the bridge round-trips the tree bitwise."""
    cfg, jcfg = _configs(name)
    sd = init_variables(cfg.model, torch.Generator().manual_seed(1))
    shapes = jax.eval_shape(JaxDetector(cfg=jcfg.model).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tree = to_jax_variables(sd)
    assert set(tree) == set(shapes)          # VGG has no FrozenBN constants
    assert {k: v.shape for k, v in _leaves(tree).items()} == want
    if name == "vgg16_voc07":
        assert "['params']['backbone']['group5']['conv5_3']['bias']" in want
        assert want["['params']['box_head']['fc6']['kernel']"] == (7 * 7 * 512, 64)
    else:
        assert any("layer4_block2" in k for k in want) and not any("fpn" in k for k in want)
        assert want["['params']['box_head']['fc6']['kernel']"] == (7 * 7 * 1024, 64)
    back = from_jax_variables(tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    TwoStageDetector(cfg.model, device="meta").load_state_dict(back, assign=True)


# ---------------------------------------------------------------------------
# ROIAlign


def _c4_rois(rng, n, h, w):
    """Rois on an (h, w)-pixel canvas: C4-sized (up to the whole map and
    past it), tiny and degenerate ones."""
    ctr = rng.uniform(0, [w, h], (n, 2))
    size = rng.uniform(4, 1.3 * max(h, w), (n, 2))
    out = np.concatenate([ctr - size / 2, ctr + size / 2], 1).astype(np.float32)
    out[:4] = [[0, 0, w, h], [-40, -40, w + 40, h + 40], [7, 7, 7, 7], [30, 30, 20, 25]]
    return out


@pytest.fixture(scope="module")
def roi_case():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 12, 20, 32).astype(np.float32)
    rois = np.stack([_c4_rois(rng, 40, 192, 320), _c4_rois(rng, 40, 192, 320)])
    return feats, rois


def test_roi_align_matches_jax(roi_case):
    feats, rois = roi_case
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(rois), 7, 1.0 / 16, 2)
    want = jax.vmap(lambda f, r: jax_roi_align(f, r, 7, 1.0 / 16, 2))(
        jnp.asarray(feats), jnp.asarray(rois))
    assert got.shape == (2, 40, 7, 7, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ROI_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_level_pyramid_is_single_level_roi_align_bitwise(roi_case, dtype):
    """Every roi lands on level 4 whatever its extent, at scale 2**-4."""
    feats, rois = roi_case
    f, r = torch.from_numpy(feats).to(dtype), torch.from_numpy(rois)
    want = roi_align(f, r, 7, 1.0 / 16, 2)
    assert torch.equal(multilevel_roi_align({4: f}, r, 7, 2), want)
    assert want.dtype == dtype


def test_graph_pools_c4_through_the_kernel_path_and_the_plain_one(roi_case):
    """``roi_align_impl`` pallas (B1's plain version on the CPU, with grad:
    the B1/B2 autograd Function) and xla (``roi_align``) agree bitwise in
    the forward."""
    feats, rois = roi_case
    cfg = get_config("r50_coco").model
    f = torch.from_numpy(feats).requires_grad_()
    got = TG._pool_rois_impl(cfg, {4: f}, torch.from_numpy(rois), 7, (4,))
    plain = TG._pool_rois_impl(dataclasses.replace(
        cfg, rcnn=dataclasses.replace(cfg.rcnn, roi_align_impl="xla")), {4: f},
        torch.from_numpy(rois), 7, (4,))
    assert torch.equal(got, plain) and got.grad_fn is not None


# ---------------------------------------------------------------------------
# Proposals


def _rpn_inputs(seed, exact_decode):
    """Scores, deltas and the C4 anchors of a 6x8 map (432 anchors) for
    two images.  ``exact_decode``: centre deltas on a 1/16 grid and size
    deltas 0, so every decode product is exact in both frameworks."""
    cfg = get_config("r50_coco").model
    anchors = TG.level_anchors(cfg, {4: torch.empty(1, 6, 8, 1)})[4].numpy()
    rng = np.random.RandomState(seed)
    scores = (np.round(rng.rand(2, len(anchors)) * 40) / 40).astype(np.float32)
    deltas = (rng.randn(2, len(anchors), 4) * 0.3).astype(np.float32)
    if exact_decode:
        deltas = np.round(deltas * 16) / 16
        deltas[..., 2:] = 0.0
    return scores, deltas.astype(np.float32), anchors


@pytest.mark.parametrize("middle", ["dense", "pallas-nms", "fused"])
def test_proposals_bitwise_in_all_three_middles(middle):
    kw = dict(pre_nms_top_n=200, post_nms_top_n=64, nms_threshold=0.7, min_size=2.0)
    port_kw = {"dense": {}, "pallas-nms": dict(nms_impl="pallas"),
               "fused": dict(fused_middle=True)}[middle]
    jax_kw = {"dense": {}, "pallas-nms": dict(nms_impl="pallas", pallas_interpret=True),
              "fused": dict(fused_middle=True, pallas_interpret=True)}[middle]
    hw = np.array([[96.0, 128.0], [70.0, 100.0]], np.float32)
    for exact in (False, True):
        scores, deltas, anchors = _rpn_inputs(5, exact)
        got = generate_proposals(_t(scores), _t(deltas), _t(anchors), _t(hw), **kw, **port_kw)
        assert got.rois.shape == (2, 64, 4) and got.valid.sum() > 20
        for i in range(2):
            args = (jnp.asarray(scores[i]), jnp.asarray(deltas[i]), jnp.asarray(anchors),
                    hw[i, 0], hw[i, 1])
            refs = [jax_generate_proposals(*args, **kw)]
            if exact or middle != "fused":
                # The interpret-mode fused middle contracts the decode into
                # FMAs: bitwise where the decode is exact.
                refs.append(jax_generate_proposals(*args, **kw, **jax_kw))
            for want in refs:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Inference


@pytest.mark.parametrize("nms_mode", ["fused", "per_class"])
def test_forward_inference_matches_jax(models, nms_mode):
    cfg = apply_overrides(models["cfg"], [f"model.test.nms_mode={nms_mode}"])
    jcfg = jax_overrides(models["jcfg"], [f"model.test.nms_mode={nms_mode}"])
    images = np.random.RandomState(7).randn(2, 96, 128, 3).astype(np.float32)
    port = models["port"]
    port.cfg = cfg.model
    jbatch = JaxBatch(images=jnp.asarray(images), image_hw=jnp.asarray(HW),
                      gt_boxes=jnp.zeros((2, 8, 4)), gt_classes=jnp.zeros((2, 8), jnp.int32),
                      gt_valid=jnp.zeros((2, 8), bool))
    want = JG.forward_inference(JaxDetector(cfg=jcfg.model), models["variables"], jbatch)
    with torch.inference_mode():
        got = TG.forward_inference(port, Batch(images=_t(images), image_hw=_t(HW)))
    for i in range(2):
        ref = unletterbox_detections(*(np.asarray(x[i]) for x in want[:4]), 1.0, 96, 128)
        out = unletterbox_detections(*(x[i].numpy() for x in got[:4]), 1.0, 96, 128)
        assert len(ref["scores"]) >= 5
        assert match_fraction(ref, out, min_iou=0.9, score_tol=1e-3) >= 0.9


# ---------------------------------------------------------------------------
# Training


def _uniforms(keys, n):
    def one(k):
        k_fg, k_bg = jax.random.split(k)
        return jax.random.uniform(k_fg, (n,)), jax.random.uniform(k_bg, (n,))
    fg, bg = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(fg)), torch.from_numpy(np.array(bg))


def _synthetic_batch(cfg, n=2):
    ds = SyntheticDataset(image_hw=tuple(cfg.data.image_size), num_classes=cfg.model.num_classes)
    return assemble([ds.record(i) for i in range(n)], cfg.data, "cpu")


def test_forward_train_and_grads_match_jax():
    """r50_coco: loss, metrics and every gradient; layer4's is zero in
    both (no output reads it)."""
    cfg, jcfg = _configs("r50_coco", ["model.rpn.loss_impl=compact", *TRAIN_CANVAS])
    stats = (cfg.data.pixel_mean, cfg.data.pixel_std)
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    batch = _synthetic_batch(cfg)
    model = TwoStageDetector(cfg.model, device="cpu")
    model.load_state_dict(sd)
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(sd))
    jbatch = JaxBatch(*(jnp.asarray(x.numpy()) for x in batch[:5]))
    keys = (jax.random.split(jax.random.PRNGKey(5), 2), jax.random.split(jax.random.PRNGKey(6), 2))
    jmodel = JaxDetector(cfg=jcfg.model)

    def loss(params):
        return JG.forward_train(jmodel, {"params": params, "constants": variables["constants"]},
                                None, jbatch, pixel_stats=stats, rngs=keys)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    n_anchors = 9 * (192 // 16) * (256 // 16)
    n_rows = cfg.model.rpn.train_post_nms_top_n + cfg.data.max_gt_boxes
    draws = TG.Draws(*_uniforms(keys[0], n_anchors), *_uniforms(keys[1], n_rows))
    total, tm = TG.forward_train(model, batch, draws, stats)
    total.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    assert all(p.grad is None for n, p in model.named_parameters() if ".layer4_" in n)

    tm = {k: float(v.detach()) for k, v in tm.items()}
    for k in METRICS:
        np.testing.assert_allclose(tm[k], float(jm[k]), err_msg=k, **TRAIN_TOL)
    assert tm["RPNAcc"] == float(jm["RPNAcc"]) and tm["RCNNAcc"] == float(jm["RCNNAcc"])
    assert tm["RCNNL1Loss"] > 0 and tm["RPNL1Loss"] > 0
    want, got = _leaves(jg), _leaves(to_jax_variables(grads)["params"])
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if "layer4_" in k:
            assert not w.any() and not g.any(), k
        elif "backbone" in k:
            assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w) + 1e-12, k
        else:
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max() + 1e-12, k


def _train_steps(cfg, steps):
    model, opt, state, step_fn, global_batch = build_all(cfg, "cpu")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _synthetic_batch(cfg, global_batch)
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
        assert float(metrics["nonfinite"]) == 0.0
    return model, opt, start, global_batch


def test_layer4_gets_the_optax_weight_decay_and_momentum_update():
    """Two train steps of r50_coco: layer4 is in the optimizer with a zero
    gradient, so only the decay and the momentum move it, exactly as the
    JAX chain (clip, add_decayed_weights, sgd) moves it."""
    cfg, jcfg = _configs("r50_coco", ["model.rpn.loss_impl=compact", *TRAIN_CANVAS])
    model, opt, start, global_batch = _train_steps(cfg, 2)
    assert any(".layer4_" in n for n in opt.names)
    sched = scale_schedule_steps(cfg.train.schedule, global_batch)
    jtc = dataclasses.replace(jcfg.train, schedule=JaxSchedule(**dataclasses.asdict(sched)))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(start)["params"])
    tx, _ = make_optimizer(jtc, params, lr_scale=global_batch / 16,
                           freeze_prefixes=JAX_FREEZE["resnet50"])
    opt_state = tx.init(params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    for _ in range(2):
        updates, opt_state = tx.update(zeros, opt_state, params)
        params = optax.apply_updates(params, updates)
    want = {k: v for k, v in _leaves(params).items() if "layer4_" in k}
    got = _leaves(to_jax_variables({n: p.detach() for n, p in model.named_parameters()})
                  ["params"])
    moved = 0
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        moved += not np.array_equal(w, _leaves(to_jax_variables(start)["params"])[k])
    assert moved == sum(not k.endswith("['bias']") for k in want) > 0


def test_vgg_groups_1_and_2_stay_frozen():
    """One vgg16_voc07 step (lr raised so that every update shows in
    float32): groups 1-2 are out of the optimizer and unchanged, every
    other parameter moved."""
    cfg, _ = _configs("vgg16_voc07", [*TRAIN_CANVAS, "train.schedule.base_lr=1.0"])
    model, _, start, _ = _train_steps(cfg, 1)
    for name, p in model.named_parameters():
        frozen = name.startswith(("backbone.group1.", "backbone.group2."))
        assert p.requires_grad != frozen, name
        assert torch.equal(p.detach(), start[name]) == frozen, name


# ---------------------------------------------------------------------------
# Checkpoints and the VOC metric


def test_c4_checkpoint_passes_the_jax_manifest_check(tmp_path):
    cfg, _ = _configs("r50_coco")
    _, _, state, _, _ = build_all(cfg, "cpu")
    state.step = 3
    C.save_checkpoint(str(tmp_path), C.state_payload(state))
    assert jax_verify_manifest(str(tmp_path), 3) == (True, "ok")
    _, _, fresh, _, _ = build_all(apply_overrides(cfg, ["train.seed=9"]), "cpu")
    restored = C.restore_checkpoint(str(tmp_path), fresh)
    sd, back = state.model.state_dict(), restored.model.state_dict()
    assert any("layer4_" in k for k in back)
    assert all(torch.equal(sd[k], back[k]) for k in sd)


def test_voc07_metric_at_the_vgg_canvas_matches_jax():
    """VOC-layout records (landscape and portrait, with difficult objects)
    on the 608x1024 canvas at batch 1: the detections a stand-in eval
    step gives come back to image coordinates as in JAX, and the 11-point
    AP that ``default_use_07_metric`` picks for ``2007_test`` equals
    JAX's."""
    from mx_rcnn_tpu.data.loader import DetectionLoader
    from mx_rcnn_tpu.detection.graph import Detections as JaxDetections
    from mx_rcnn_tpu.evalutil import collect_detections as jax_collect_detections
    from mx_rcnn_tpu_torch.data.loader import eval_batches

    cfg, jcfg = get_config("vgg16_voc07"), jax_get_config("vgg16_voc07")
    assert default_use_07_metric(cfg) and not default_use_07_metric(get_config("r50_coco"))
    rng = np.random.RandomState(11)
    ours, theirs = [], []
    for i, (h, w) in enumerate([(375, 500), (500, 375), (333, 500), (500, 400)]):
        n = rng.randint(2, 5)
        xy = rng.uniform(0, [w * 0.6, h * 0.6], (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 150, (n, 2))], 1).astype(np.float32)
        classes = rng.randint(1, 21, n).astype(np.int32)
        ign = rng.rand(n) < 0.25
        order = np.argsort(ign, kind="mergesort")
        boxes, classes, ign = boxes[order], classes[order], ign[order]
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ours.append(RoiRecord(f"{i:06d}", "", h, w, boxes, classes, ignore=ign, image_array=img))
        theirs.append(JaxRecord(f"{i:06d}", "", h, w, boxes, classes, ignore=ign,
                                image_array=img))

    def stand_in(image_hw):
        """The record's gt (found by its aspect ratio, distinct here),
        letterboxed and jittered, plus a false positive."""
        (h, w), = image_hw
        rec = min(ours, key=lambda r: abs(r.height / r.width - h / w))
        scale = h / rec.height
        boxes = np.concatenate([rec.boxes * scale + rng.uniform(-4, 4, rec.boxes.shape),
                                [[5, 5, 60, 60]]]).astype(np.float32)[None]
        k = boxes.shape[1]
        scores = rng.rand(1, k).astype(np.float32)
        classes = np.concatenate([rec.gt_classes, [1]]).astype(np.int32)[None]
        return boxes, scores, classes, np.ones((1, k), bool)

    dets = []
    loader = DetectionLoader(theirs, jcfg.data, batch_size=1, train=False, prefetch=False,
                             num_workers=0, service_workers=0)
    want = jax_collect_detections(
        lambda v, b: JaxDetections(*dets.append(stand_in(np.asarray(b.image_hw)))
                                   or dets[-1]), None, loader)
    replay = iter(dets)
    got = TPE.collect_detections(
        lambda m, b: TG.Detections(*(torch.from_numpy(x) for x in next(replay))), None,
        eval_batches(ours, cfg.data, 1, "cpu"), cfg.data)
    assert got.keys() == want.keys() == {r.image_id for r in ours}
    for k in want:
        for f in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[k][f], want[k][f], err_msg=f"{k} {f}")
    names = ("__background__",) + VOC_CLASSES
    m_got = TPE.evaluate_detections(got, ours, 21, "voc", names,
                                    use_07_metric=default_use_07_metric(cfg))
    m_want = jax_evaluate_detections(want, theirs, 21, "voc", names, use_07_metric=True)
    assert m_got == m_want and 0 < m_got["mAP"] <= 1
