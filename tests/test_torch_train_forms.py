"""The single-card training forms of the port against the JAX package:
the ``bn``/``gn``/``none`` norms, backbone remat, the weight bridge, the
optimizer and the import under the norms, and the accumulated step, on
the CPU at small sizes, the same seeded numpy inputs and the same
weights (carried across by ``weights.py``) through both packages.

Tolerances, each case's own:
  * a norm module against flax: float32 within 2e-6 of the output's
    largest magnitude (flax's statistics sum in another order); bfloat16
    within one bf16 ulp of flax's output (the float32 results round to
    neighbours); the float32 gradients of ``scale``, ``bias`` and the
    input within 1e-5 of each one's largest magnitude.
  * a ResNet-50 (32x32 input, level 4) under ``gn`` or ``bn``: the
    features within 1e-4 of their largest magnitude, each parameter's
    gradient within 5e-3 in norm (``|g - g_jax| <= 5e-3 |g_jax|``, as
    ``test_torch_train.py`` holds random-weight backbones).
  * the accumulated step (``accum_steps=2``, microbatches of 2) against
    JAX's ``make_train_step(accum_steps=2)``: the loss and the six
    metrics rtol 2e-6, atol 1e-7, the accuracies exactly, ``lr`` bitwise,
    every parameter after the update within 1e-6.
  * the accumulated step against the port's one step over all four
    images on the same draws: metrics rtol 1e-4, atol 1e-5 (the
    accuracies 0.02), parameters rtol 1e-5, atol 2e-6: the JAX package's
    own contract (``tests/test_plan.py``), every image meeting its quota.
  * bitwise: the weight bridge for all four norms, remat on and off,
    ``accum_steps=1`` against the plain step, the ``gn`` and ``bn``
    imports against JAX's.  The loop's forms (the loader's runs,
    ``steps_per_call``, resume, the CLI) are in
    ``test_torch_train_forms_loop.py``.
  * the optimizer over ``gn`` parameters against optax: 1e-6.
"""

from __future__ import annotations

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mx_rcnn_tpu.config import BackboneConfig as JaxBackboneConfig
from mx_rcnn_tpu.config import ScheduleConfig as JaxSchedule
from mx_rcnn_tpu.config import TrainConfig as JaxTrain
from mx_rcnn_tpu.config import apply_overrides as jax_overrides
from mx_rcnn_tpu.config import get_config as jax_get_config
from mx_rcnn_tpu.detection import Batch as JaxBatch
from mx_rcnn_tpu.detection import TwoStageDetector as JaxDetector
from mx_rcnn_tpu.models.build import build_backbone as jax_build_backbone
from mx_rcnn_tpu.models.norm import make_norm as jax_make_norm
from mx_rcnn_tpu.parallel.step import make_train_step as jax_make_train_step
from mx_rcnn_tpu.train.import_torch import load_pretrained_backbone as jax_load
from mx_rcnn_tpu.train.loop import FREEZE_PREFIXES as JAX_FREEZE
from mx_rcnn_tpu.train.optim import make_optimizer
from mx_rcnn_tpu.train.state import TrainState as JaxTrainState
from mx_rcnn_tpu_torch.config import (
    BackboneConfig,
    ScheduleConfig,
    TrainConfig,
    apply_overrides,
    get_config,
)
from mx_rcnn_tpu_torch.data.datasets import SyntheticDataset
from mx_rcnn_tpu_torch.data.loader import assemble
from mx_rcnn_tpu_torch.detection.detector import TwoStageDetector
from mx_rcnn_tpu_torch.detection.graph import BatchDraws, Draws
from mx_rcnn_tpu_torch.models.build import build_backbone
from mx_rcnn_tpu_torch.models.norm import make_norm
from mx_rcnn_tpu_torch.parallel.step import make_train_step
from mx_rcnn_tpu_torch.train.import_torch import load_pretrained_backbone
from mx_rcnn_tpu_torch.train.loop import FREEZE_PREFIXES, build_all
from mx_rcnn_tpu_torch.train.optim import SGDMomentum, frozen_mask, make_schedule
from mx_rcnn_tpu_torch.weights import (
    collection,
    from_jax_variables,
    init_variables,
    is_constant,
    to_jax_variables,
)

from test_torch_import_torch import torchvision_resnet
from test_torch_train import STATS, _leaves, _uniforms

torch.set_num_threads(2)

METRICS = ("RPNAcc", "RPNLogLoss", "RPNL1Loss", "RCNNAcc", "RCNNLogLoss", "RCNNL1Loss", "loss")
NORMS = ("frozen_bn", "bn", "gn", "none")


@pytest.fixture
def work(tmp_path):
    """``tmp_path``, emptied after the test: a checkpoint of these
    full-width ResNet-50 models holds over 200 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny(*overrides):
    return apply_overrides(get_config("tiny_synthetic"), list(overrides))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _randomize_norms(variables, rng):
    """Norm tensors off their identity init: scale 1 + 0.1 N, bias 0.1 N,
    mean 0.1 N, var in [0.5, 1.5)."""
    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if name.endswith("['bias']") or name.endswith("['mean']"):
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (0.5 + rng.random_sample(v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _by_norm(got, want, tol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= tol * np.linalg.norm(w) + 1e-12, k


# ---------------------------------------------------------------------------
# The norms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bn", "gn", "none"])
def test_norm_matches_flax(kind, dtype):
    rng = np.random.RandomState(3)
    x = (2.0 + 3.0 * rng.standard_normal((2, 6, 5, 64))).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jax_make_norm(kind, jdt)
    variables = _randomize_norms(jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt)), rng)
    xj = jnp.asarray(x, jdt)
    want = np.asarray(jm.apply(variables, xj).astype(jnp.float32))

    module = make_norm(kind, 64, tdt)
    module.load_state_dict(from_jax_variables(variables), strict=True)
    module.train()                      # the trainer's mode changes nothing
    xt = _nchw(x).to(tdt).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = module(xt)
    assert y.dtype == tdt
    got = y.float().permute(0, 2, 3, 1).detach().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
    else:
        e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
        assert np.all(np.abs(got - want) <= np.exp2(e - 7)), np.abs(got - want).max()
    if kind == "bn":
        np.testing.assert_array_equal(module.mean.numpy(),
                                      variables["batch_stats"]["mean"])
    if dtype == "bfloat16" or kind == "none":
        return

    def loss(params, x):
        return jnp.sum(jm.apply({**variables, "params": params}, x) ** 2)

    jg, jgx = jax.grad(loss, argnums=(0, 1))(variables["params"], xj)
    (y.float() ** 2).sum().backward()
    for name in ("scale", "bias"):
        g, w = getattr(module, name).grad.numpy(), np.asarray(jg[name])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
    gx, wx = xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx)
    np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-5 * np.abs(wx).max())


def test_bn_is_not_live_batch_norm():
    """``bn`` normalizes by its stored statistics in train mode too, and
    they never change: not ``nn.BatchNorm2d``."""
    m = make_norm("bn", 32, torch.float32)
    m.train()
    x = torch.randn(4, 32, 3, 3) * 5 + 2
    before = {k: v.clone() for k, v in m.state_dict().items()}
    y = m(x)
    torch.testing.assert_close(y, (x - 0.0) / np.sqrt(1 + 1e-5), rtol=0, atol=1e-6)
    assert all(torch.equal(v, before[k]) for k, v in m.state_dict().items())
    assert {n for n, _ in m.named_parameters()} == {"scale", "bias"}
    assert {n for n, _ in m.named_buffers()} == {"mean", "var"}


def test_unknown_norm_and_forms_are_refused_as_jax_refuses():
    with pytest.raises(ValueError, match="unknown norm 'ln'"):
        BackboneConfig(norm="ln")
    with pytest.raises(ValueError, match="unknown norm 'ln'"):
        _tiny("model.backbone.norm=ln")
    with pytest.raises(ValueError, match="must be >= 1"):
        TrainConfig(accum_steps=0)
    with pytest.raises(ValueError, match="must be >= 1"):
        TrainConfig(steps_per_call=0)
    with pytest.raises(ValueError, match="pick one"):
        _tiny("train.accum_steps=2", "train.steps_per_call=2")
    # The JAX plan refuses the same combinations.
    from mx_rcnn_tpu.parallel.plan import ExecutionPlan

    with pytest.raises(ValueError, match="pick one"):
        ExecutionPlan(accum_steps=2, steps_per_call=2)
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("accum_steps", "steps_per_call"):
            assert f.default == next(g.default for g in dataclasses.fields(JaxTrain)
                                     if g.name == f.name)
    assert BackboneConfig().remat == JaxBackboneConfig().remat is False


# ---------------------------------------------------------------------------
# The backbone under each norm, and remat


@pytest.fixture(scope="module", params=["gn", "bn"])
def resnet_pair(request):
    norm = request.param
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jm = jax_build_backbone(JaxBackboneConfig(name="resnet50", dtype="float32", norm=norm),
                            out_levels=(4,))
    variables = _randomize_norms(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                                 np.random.RandomState(1))
    port = build_backbone(BackboneConfig(name="resnet50", norm=norm), torch.float32,
                          out_levels=(4,))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return norm, x, jm, variables, port


def test_resnet50_backbone_matches_jax(resnet_pair):
    norm, x, jm, variables, port = resnet_pair
    xj = jnp.asarray(x)

    def loss(params):
        f = jm.apply({**variables, "params": params}, xj)[4]
        return jnp.sum(f ** 2), f

    (_, want), jg = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    port.train()
    feats = port(_nchw(x))[4]
    got = feats.permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    (feats ** 2).sum().backward()
    # layer4 is built but not run at level 4: JAX's gradient there is 0.
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in port.named_parameters()}
    _by_norm(_leaves(to_jax_variables(grads, norm)["params"]), _leaves(jg), 5e-3)
    if norm == "bn":
        stats = _leaves(variables["batch_stats"])
        back = _leaves(to_jax_variables(port.state_dict(), norm)["batch_stats"])
        assert back.keys() == stats.keys()
        assert all(np.array_equal(back[k], stats[k]) for k in stats)


@pytest.mark.parametrize("norm", NORMS)
def test_weights_round_trip_for_every_norm(norm):
    """The JAX detector's variables under ``norm`` (its own tree, from
    ``eval_shape`` of its init, seeded values) load strictly into the
    port's model and come back bitwise, in the same collections."""
    jcfg = jax_overrides(jax_get_config("tiny_synthetic"), [f"model.backbone.norm={norm}"])
    shapes = jax.eval_shape(JaxDetector(cfg=jcfg.model).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *jcfg.data.image_size, 3)))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                                  shapes)
    want_colls = {"frozen_bn": {"params", "constants"}, "bn": {"params", "batch_stats"},
                  "gn": {"params"}, "none": {"params"}}[norm]
    assert set(tree) == want_colls
    model = TwoStageDetector(_tiny(f"model.backbone.norm={norm}").model, device="cpu")
    model.load_state_dict(from_jax_variables(tree), strict=True)
    back = to_jax_variables(model.state_dict(), norm)
    assert set(back) == want_colls
    got, want = _leaves(back), _leaves(tree)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    # init_variables draws the same shapes, identity norms.
    sd = init_variables(model.cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in from_jax_variables(tree).items()}
    if norm != "none":
        assert torch.equal(sd["backbone.bn1.scale"], torch.ones(64))
        assert torch.equal(sd["backbone.bn1.bias"], torch.zeros(64))


def test_is_constant_on_bn_modules():
    """A ``bn`` module has a ``var`` as FrozenBN does, but its ``scale``
    and ``bias`` are trainable parameters, not constants."""
    sd = TwoStageDetector(_tiny("model.backbone.norm=bn").model, device="meta").state_dict()
    assert not is_constant("backbone.bn1.scale", sd, "bn")
    assert not is_constant("backbone.layer1_block0.downsample_bn.bias", sd, "bn")
    assert collection("backbone.bn1.mean", sd, "bn") == "batch_stats"
    assert collection("backbone.bn1.var", sd, "bn") == "batch_stats"
    assert collection("backbone.bn1.scale", sd, "frozen_bn") == "constants"
    assert collection("backbone.conv1.weight", sd, "bn") == "params"


@pytest.mark.parametrize("name", ["resnet50", "vgg16"])
def test_remat_is_bitwise_the_stored_form(name):
    """Remat on and off: the same parameter names, values and gradients,
    bit for bit; under remat the frozen stages' parameters and buffers
    stay without ``requires_grad`` and get no gradient."""
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32))
    nets = [build_backbone(BackboneConfig(name=name, norm="bn", remat=remat), torch.float32,
                           out_levels=(4,)) for remat in (False, True)]
    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in nets[0].state_dict().items():
        if v.dim() == 4:        # lecun-normal kernels, norms off identity
            sd[k] = torch.randn(v.shape, generator=g) / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith((".scale", ".var")):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    frozen = FREEZE_PREFIXES[name]
    outs = []
    for net in nets:
        net.load_state_dict(sd)
        mask = frozen_mask([f"backbone.{n}" for n, _ in net.named_parameters()], frozen)
        for n, p in net.named_parameters():
            p.requires_grad_(mask[f"backbone.{n}"])
        y = net(_nchw(x.numpy()))[4]
        (y ** 2).sum().backward()
        outs.append((y.detach(), {n: p.grad for n, p in net.named_parameters()}))
        assert not any(b.requires_grad for b in net.buffers())
    assert list(outs[0][1]) == list(outs[1][1])
    assert torch.equal(outs[0][0], outs[1][0])
    for n, g in outs[0][1].items():
        h = outs[1][1][n]
        assert (g is None) == (h is None), n
        assert g is None or torch.equal(g, h), n
    frozen_names = [n for n in outs[1][1] if not mask[f"backbone.{n}"]]
    assert frozen_names and all(outs[1][1][n] is None for n in frozen_names)


# ---------------------------------------------------------------------------
# The accumulated step


def _four_images(cfg):
    ds = SyntheticDataset(image_hw=tuple(cfg.data.image_size), num_classes=5)
    return [assemble([ds.record(2 * j), ds.record(2 * j + 1)], cfg.data, "cpu")
            for j in range(2)]


def test_accum_step_matches_jax():
    overrides = ["train.per_device_batch=2", "train.accum_steps=2"]
    cfg = _tiny(*overrides)
    jcfg = jax_overrides(jax_get_config("tiny_synthetic"), overrides)
    sd = init_variables(cfg.model, torch.Generator().manual_seed(0))
    _, _, state, step_fn, global_batch = build_all(cfg, device="cpu", variables=sd)
    assert global_batch == 4
    micro = _four_images(cfg)

    variables = to_jax_variables(sd)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx, schedule = make_optimizer(jcfg.train, params, lr_scale=4 / 16)
    jmodel = JaxDetector(cfg=jcfg.model)
    jstep = jax_make_train_step(jmodel, tx, schedule, accum_steps=2, pixel_stats=STATS)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           model_state={"constants": variables["constants"]},
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(7))
    stacked = JaxBatch(*(jnp.asarray(np.stack([m[i].numpy() for m in micro]))
                         for i in range(5)))
    # The JAX step's per-image keys over the whole batch of four.
    rng = jax.random.fold_in(jstate.rng, 0)
    rng_assign, rng_sample = jax.random.split(rng)
    n_anchors = sum(3 * (128 >> l) ** 2 for l in range(2, 7))
    n_rows = cfg.model.rpn.train_post_nms_top_n + cfg.data.max_gt_boxes
    draws = Draws(*_uniforms(jax.random.split(rng_assign, 4), n_anchors),
                  *_uniforms(jax.random.split(rng_sample, 4), n_rows))
    jnew, jm = jstep(jstate, stacked)
    state, tm = step_fn(state, micro, draws=draws)

    assert state.step == 1 and state.optimizer.step == 1
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6, atol=1e-7, err_msg=k)
    for k in ("RPNAcc", "RCNNAcc", "lr", "nonfinite"):
        assert float(tm[k]) == float(jm[k]), k
    got = _leaves(to_jax_variables({n: p.detach() for n, p in
                                    state.model.named_parameters()})["params"])
    want = _leaves(jax.device_get(jnew.params))
    start = _leaves(variables["params"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    assert sum(not np.array_equal(got[k], start[k]) for k in got) > len(got) // 2


def test_accum_step_matches_the_step_over_the_whole_batch():
    """Two microbatches of two against one step over the four images on
    the same generator: the same draws row for row, and the JAX
    package's accumulation contract on the result (every image meets its
    anchor quota with ``allowed_border`` wide, as ``test_plan.py`` sets
    it)."""
    common = ["model.rpn.allowed_border=1000.0"]
    acc_cfg = _tiny(*common, "train.per_device_batch=2", "train.accum_steps=2")
    flat_cfg = _tiny(*common, "train.per_device_batch=4")
    sd = init_variables(acc_cfg.model, torch.Generator().manual_seed(0))
    micro = _four_images(acc_cfg)
    flat = type(micro[0])(*(None if a is None else torch.cat([a, b])
                            for a, b in zip(*micro)))
    runs = []
    for cfg, batch in ((acc_cfg, micro), (flat_cfg, flat)):
        _, _, state, step_fn, global_batch = build_all(cfg, device="cpu", variables=sd)
        assert global_batch == 4
        runs.append(step_fn(state, batch))
    (s_acc, m_acc), (s_flat, m_flat) = runs
    for k in m_flat:
        tol = dict(rtol=0.0, atol=0.02) if k.endswith("Acc") else dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(m_acc[k]), float(m_flat[k]), err_msg=k, **tol)
    flat_params = dict(s_flat.model.named_parameters())
    for n, p in s_acc.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat_params[n].detach().numpy(),
                                   rtol=1e-5, atol=2e-6, err_msg=n)


def test_batch_draws_hand_out_the_whole_batchs_rows():
    g = torch.Generator().manual_seed(4)
    want = [torch.rand((4, 7), generator=g), torch.rand((4, 7), generator=g),
            torch.rand((4, 3), generator=g), torch.rand((4, 3), generator=g)]
    whole = BatchDraws(g.manual_seed(4), 4)
    got = {j: [whole.field(f, shape, "cpu", whole.micro(j, 2).lo)
               for f, shape in zip(Draws._fields, [(2, 7), (2, 7), (2, 3), (2, 3)])]
           for j in (0, 1)}
    for i in range(4):
        assert torch.equal(torch.cat([got[0][i], got[1][i]]), want[i])
    # A microbatch whose gt padding (the R + G width) differs is refused.
    with pytest.raises(ValueError, match="sample_fg"):
        whole.field("sample_fg", (2, 5), "cpu", 2)
    with pytest.raises(ValueError, match="passes"):
        whole.micro(2, 2)


def test_accum_steps_1_is_bitwise_the_plain_step():
    cfg = _tiny()
    sd = init_variables(cfg.model, torch.Generator().manual_seed(1))
    ds = SyntheticDataset(image_hw=(128, 128), num_classes=5)
    batches = [assemble([ds.record(i)], cfg.data, "cpu") for i in range(2)]
    ends = []
    for kw in ({}, {"accum_steps": 1, "accum_dtype": torch.float32}):
        _, _, state, _, _ = build_all(cfg, device="cpu", variables=sd)
        step = make_train_step(STATS, cfg.train.seed, **kw)
        for b in batches:
            state, m = step(state, b)
        ends.append((state.model.state_dict(), m))
    (a, ma), (b, mb) = ends
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


# ---------------------------------------------------------------------------
# The optimizer and the import under gn


def test_scale_is_not_decayed():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(3))
    opt = SGDMomentum({"backbone.bn1.scale": p, "backbone.conv1.weight": q},
                      TrainConfig(weight_decay=0.5, momentum=0.0), lambda step: 1.0)
    assert opt.decays == [False, True]
    opt.apply([torch.zeros(3), torch.zeros(3)])
    assert torch.equal(p.detach(), torch.ones(3)) and torch.equal(q.detach(), torch.full((3,), 0.5))


def test_optimizer_with_gn_matches_optax():
    """As ``test_torch_train.py::test_optimizer_matches_optax``, over a
    ``gn`` model: the norm scales and biases are trainable, undecayed, and
    frozen with their stage."""
    sched = ScheduleConfig(base_lr=0.02, warmup_steps=2, decay_steps=(2,), factor=0.1,
                           total_steps=10, reference_batch=0)
    tc = TrainConfig(grad_clip=30.0, schedule=sched)
    jtc = JaxTrain(grad_clip=30.0, schedule=JaxSchedule(**dataclasses.asdict(sched)))
    cfg = _tiny("model.backbone.norm=gn").model
    sd = init_variables(cfg, torch.Generator().manual_seed(1))
    model = TwoStageDetector(cfg, device="cpu")
    model.load_state_dict(sd)
    params = dict(model.named_parameters())
    assert "backbone.layer2_block0.bn1.scale" in params
    trainable = frozen_mask(params, FREEZE_PREFIXES["resnet50"])
    assert not trainable["backbone.bn1.scale"] and not trainable["backbone.layer1_block2.bn3.bias"]
    opt = SGDMomentum({n: p for n, p in params.items() if trainable[n]}, tc,
                      make_schedule(sched, 2 / 16))
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(sd, "gn")["params"])
    tx, jsched = make_optimizer(jtc, jparams, lr_scale=2 / 16,
                                freeze_prefixes=JAX_FREEZE["resnet50"])
    state = tx.init(jparams)
    rng = np.random.RandomState(0)
    for step in range(3):
        grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)
                                     * (0.05 if step != 1 else 1.0))
                 for n, p in params.items()}
        jgrads = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(grads, "gn")["params"])
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = opt.apply([grads[n] for n in opt.names])
        assert np.float32(lr) == np.asarray(jsched(step)), step
    want = _leaves(jparams)
    got = _leaves(to_jax_variables({n: p.detach() for n, p in params.items()}, "gn")["params"])
    start = _leaves(to_jax_variables(sd, "gn")["params"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    assert not np.array_equal(got["['backbone']['layer2_block0']['bn1']['scale']"],
                              start["['backbone']['layer2_block0']['bn1']['scale']"])
    assert np.array_equal(got["['backbone']['bn1']['scale']"], start["['backbone']['bn1']['scale']"])


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_pretrained_import_loads_convs_only(norm, work):
    """Under ``gn`` or ``bn`` the file's convolutions load and every norm
    keeps its init, as JAX's importer does; the result is JAX's bitwise."""
    path = work / "r50.pth"
    torch.save(torchvision_resnet("resnet50"), path)
    cfg = _tiny(f"model.backbone.norm={norm}").model
    sd = init_variables(cfg, torch.Generator().manual_seed(0))
    got = load_pretrained_backbone(sd, str(path), norm)
    theirs = from_jax_variables(jax_load(to_jax_variables(sd, norm), str(path)))
    assert got.keys() == theirs.keys()
    assert all(torch.equal(got[k], theirs[k]) for k in got)
    assert not torch.equal(got["backbone.layer1_block0.conv1.weight"],
                           sd["backbone.layer1_block0.conv1.weight"])
    norm_keys = [k for k in sd if ".bn" in k or "downsample_bn" in k]
    assert norm_keys and all(torch.equal(got[k], sd[k]) for k in norm_keys)
    torch.save({"fc.weight": torch.zeros(2, 2)}, work / "fc.pth")
    with pytest.raises(ValueError, match="matched no tensor"):
        load_pretrained_backbone(sd, str(work / "fc.pth"), norm)
