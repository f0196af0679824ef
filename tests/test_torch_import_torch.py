"""The pretrained import against ``mx_rcnn_tpu/train/import_torch.py`` on
torchvision-layout ResNet and VGG-16 state_dicts the tests write from a
seed (the key names of ``torchvision.models.resnet50/101`` and
``vgg16``, ``fc.*``, the classifier and ``num_batches_tracked``
included): the port's state_dict after ``load_pretrained_backbone``
equals the JAX variables after theirs, carried across by
``weights.from_jax_variables``, bitwise, for ResNet-50, ResNet-101 and
VGG-16 (fc6/fc7 seeded from the classifier, or kept with a warning when
the box head's dimensions differ); a shape mismatch, another VGG variant
and a file that matches nothing raise in both; ``build_all(pretrained=)``
and ``train_cli --pretrained`` train from it.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.train.import_torch import load_pretrained_backbone as jax_load
from mx_rcnn_tpu_torch.config import BackboneConfig, apply_overrides, get_config
from mx_rcnn_tpu_torch.models.resnet import STAGE_BLOCKS
from mx_rcnn_tpu_torch.train.import_torch import load_pretrained_backbone, map_torch_resnet
from mx_rcnn_tpu_torch.train.loop import build_all
from mx_rcnn_tpu_torch.weights import from_jax_variables, init_variables, to_jax_variables

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _remove_written_files(tmp_path):
    """Checkpoints and .pth files here are 100-200 MB each: delete them
    when the test ends rather than leave them to pytest's retention."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

def torchvision_resnet(name: str, seed: int = 0) -> dict[str, torch.Tensor]:
    """A state_dict with torchvision's ResNet key names and shapes."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = torch.randn((cout, cin, k, k), generator=g) * 0.05

    def bn(key, c):
        sd[f"{key}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, width) in enumerate(zip(STAGE_BLOCKS[name], (64, 128, 256, 512)), start=1):
        for b in range(n):
            t = f"layer{li}.{b}"
            conv(f"{t}.conv1", width, cin, 1)
            bn(f"{t}.bn1", width)
            conv(f"{t}.conv2", width, width, 3)
            bn(f"{t}.bn2", width)
            conv(f"{t}.conv3", 4 * width, width, 1)
            bn(f"{t}.bn3", 4 * width)
            if b == 0:
                conv(f"{t}.downsample.0", 4 * width, cin, 1)
                bn(f"{t}.downsample.1", 4 * width)
            cin = 4 * width
    sd["fc.weight"] = torch.randn((1000, 2048), generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _model(name: str):
    cfg = get_config("tiny_synthetic")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=BackboneConfig(name=name, freeze_stages=2, dtype="float32")))


@pytest.mark.parametrize("name", ["resnet50", "resnet101"])
def test_import_matches_jax(tmp_path, name):
    cfg = _model(name)
    variables = init_variables(cfg.model, torch.Generator().manual_seed(1))
    sd = torchvision_resnet(name, seed=2)
    path = str(tmp_path / f"{name}.pth")
    torch.save(sd, path)
    got = load_pretrained_backbone(variables, path)
    want = from_jax_variables(jax_load(to_jax_variables(variables), path))
    assert got.keys() == want.keys() == variables.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # Every backbone tensor came from the file; nothing else moved.
    backbone = [k for k in got if k.startswith("backbone.")]
    assert len(backbone) == len(map_torch_resnet(sd))
    assert torch.equal(got["backbone.layer3_block5.bn2.var"], sd["layer3.5.bn2.running_var"])
    assert torch.equal(got["backbone.layer2_block0.downsample_conv.weight"],
                       sd["layer2.0.downsample.0.weight"])
    assert all(torch.equal(got[k], variables[k]) for k in got if k not in backbone)


def test_a_deeper_file_fills_the_shallower_backbone(tmp_path):
    """A ResNet-101 file over a ResNet-50 backbone: the blocks both have
    are copied, the rest of the file is skipped, as in JAX."""
    cfg = _model("resnet50")
    variables = init_variables(cfg.model, torch.Generator().manual_seed(1))
    path = str(tmp_path / "r101.pth")
    torch.save(torchvision_resnet("resnet101", seed=3), path)
    got = load_pretrained_backbone(variables, path)
    want = from_jax_variables(jax_load(to_jax_variables(variables), path))
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_shape_mismatch_and_no_match_raise(tmp_path):
    cfg = _model("resnet50")
    variables = init_variables(cfg.model, torch.Generator().manual_seed(1))
    sd = torchvision_resnet("resnet50")
    sd["layer1.0.conv2.weight"] = torch.zeros(64, 64, 1, 1)
    bad = str(tmp_path / "bad.pth")
    torch.save(sd, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_backbone(variables, bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_load(to_jax_variables(variables), bad)
    fc_only = str(tmp_path / "fc.pth")
    torch.save({"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}, fc_only)
    with pytest.raises(ValueError, match="matched no"):
        load_pretrained_backbone(variables, fc_only)
    with pytest.raises(KeyError, match="conv1.weight"):    # JAX's mapping needs the stem
        jax_load(to_jax_variables(variables), fc_only)


def test_build_all_starts_from_the_file(tmp_path):
    cfg = _model("resnet50")
    sd = torchvision_resnet("resnet50", seed=4)
    path = str(tmp_path / "r50.pth")
    torch.save(sd, path)
    model, _, _, _, _ = build_all(cfg, "cpu", pretrained=path)
    state = model.state_dict()
    for tkey, pkey in (("conv1.weight", "backbone.conv1.weight"),
                       ("bn1.running_mean", "backbone.bn1.mean"),
                       ("layer4.2.conv3.weight", "backbone.layer4_block2.conv3.weight")):
        assert torch.equal(state[pkey], sd[tkey]), pkey
    fresh, _, _, _, _ = build_all(cfg, "cpu")
    assert torch.equal(model.rpn_head.conv.weight, fresh.rpn_head.conv.weight)
    assert not np.array_equal(model.backbone.conv1.weight.detach().numpy(),
                              fresh.backbone.conv1.weight.detach().numpy())


def torchvision_vgg16(seed: int = 0, with_classifier: bool = True) -> dict[str, torch.Tensor]:
    """A state_dict with torchvision's VGG-16 (cfg D, no BN) key names and
    shapes, the ImageNet classifier included."""
    g = torch.Generator().manual_seed(seed)
    sd: dict[str, torch.Tensor] = {}
    cin = 3
    for idx, cout in zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                         (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        sd[f"features.{idx}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g) * 0.1
        cin = cout
    if with_classifier:
        for idx, (cout, cin) in ((0, (4096, 512 * 7 * 7)), (3, (4096, 4096)), (6, (1000, 4096))):
            sd[f"classifier.{idx}.weight"] = torch.randn((cout, cin), generator=g) * 0.01
            sd[f"classifier.{idx}.bias"] = torch.randn(cout, generator=g) * 0.1
    return sd


def _vgg(hidden_dim: int):
    cfg = get_config("vgg16_voc07")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rcnn=dataclasses.replace(cfg.model.rcnn, hidden_dim=hidden_dim)))


@pytest.mark.parametrize("hidden_dim", [4096, 64])
def test_vgg16_import_matches_jax(tmp_path, caplog, hidden_dim):
    """The trunk from ``features.*``; ``fc6``/``fc7`` from the classifier
    when the box head has its dimensions (fc6's input permuted from CHW to
    the pooled rois' HWC order), else kept at random init with a warning,
    as in JAX."""
    variables = init_variables(_vgg(hidden_dim).model, torch.Generator().manual_seed(1))
    sd = torchvision_vgg16(seed=2)
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    got = load_pretrained_backbone(variables, path)
    want = from_jax_variables(jax_load(to_jax_variables(variables), path))
    assert got.keys() == want.keys() == variables.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert torch.equal(got["backbone.group4.conv4_3.weight"], sd["features.21.weight"])
    assert torch.equal(got["backbone.group5.conv5_1.bias"], sd["features.24.bias"])
    seeded = ["box_head.fc6.weight", "box_head.fc6.bias", "box_head.fc7.weight",
              "box_head.fc7.bias"]
    moved = [k for k in got if not torch.equal(got[k], variables[k])]
    trunk = [k for k in got if k.startswith("backbone.")]
    if hidden_dim == 4096:
        assert sorted(moved) == sorted(trunk + seeded)
        w6 = sd["classifier.0.weight"].reshape(4096, 512, 7, 7)
        assert torch.equal(got["box_head.fc6.weight"].reshape(4096, 7, 7, 512)[:, 2, 5],
                           w6[:, :, 2, 5])
        assert torch.equal(got["box_head.fc7.weight"], sd["classifier.3.weight"])
    else:
        assert sorted(moved) == sorted(trunk)
        assert "fc6/fc7 keep random init" in caplog.text


def test_vgg16_variant_and_mismatch_raise(tmp_path):
    variables = init_variables(_vgg(64).model, torch.Generator().manual_seed(1))
    bn = torchvision_vgg16(with_classifier=False)
    bn["features.1.weight"] = bn.pop("features.2.weight")[:, 0, 0, 0]   # vgg16_bn-like
    bad = str(tmp_path / "vgg16_bn.pth")
    torch.save(bn, bad)
    for load in (load_pretrained_backbone, lambda v, p: jax_load(to_jax_variables(v), p)):
        with pytest.raises(ValueError, match="unsupported torchvision VGG variant"):
            load(variables, bad)
    sd = torchvision_vgg16(with_classifier=False)
    sd["features.7.weight"] = torch.zeros(128, 128, 1, 1)
    wrong = str(tmp_path / "wrong.pth")
    torch.save(sd, wrong)
    for load in (load_pretrained_backbone, lambda v, p: jax_load(to_jax_variables(v), p)):
        with pytest.raises(ValueError, match="shape mismatch"):
            load(variables, wrong)


def test_train_cli_starts_vgg16_from_the_file(tmp_path):
    """``train_cli --pretrained`` with a VGG-16 file: the step-0
    checkpoint holds the file's trunk."""
    from mx_rcnn_tpu_torch.cli import train_cli
    from mx_rcnn_tpu_torch.train.checkpoint import restore_checkpoint

    sd = torchvision_vgg16(seed=5, with_classifier=False)
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    over = ["model.rcnn.hidden_dim=64", "data.dataset=synthetic", "data.image_size=64,96",
            "data.short_side=64", "data.max_side=96", "model.rpn.train_pre_nms_top_n=100",
            "model.rpn.train_post_nms_top_n=50", "model.rcnn.roi_batch_size=16",
            "model.precision.policy=float32", "model.backbone.dtype=float32"]
    args = ["--config", "vgg16_voc07", "--steps", "1", "--device", "cpu", "--no-eval",
            "--workdir", str(tmp_path), "--pretrained", path]
    for o in over:
        args += ["--set", o]
    assert train_cli.main(args) == {"final_step": 1}
    cfg = apply_overrides(get_config("vgg16_voc07"), over)
    _, _, state, _, _ = build_all(cfg, "cpu")
    restore_checkpoint(str(tmp_path / "vgg16_voc07" / "ckpt"), state, step=0)
    got = state.model.state_dict()
    for g, layers in enumerate(((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)), 1):
        for i, idx in enumerate(layers, 1):
            assert torch.equal(got[f"backbone.group{g}.conv{g}_{i}.weight"],
                               sd[f"features.{idx}.weight"])
