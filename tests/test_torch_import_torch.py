"""The pretrained import against ``mx_rcnn_tpu/train/import_torch.py`` on
torchvision-layout ResNet state_dicts the tests write from a seed (the
key names of ``torchvision.models.resnet50/101``, ``fc.*`` and
``num_batches_tracked`` included): the port's state_dict after
``load_pretrained_backbone`` equals the JAX variables after theirs,
carried across by ``weights.from_jax_variables``, bitwise, for
ResNet-50 and ResNet-101; a shape mismatch and a file that matches
nothing raise in both; ``build_all(pretrained=)`` trains from it.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from mx_rcnn_tpu.train.import_torch import load_pretrained_backbone as jax_load
from mx_rcnn_tpu_torch.config import BackboneConfig, get_config
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
