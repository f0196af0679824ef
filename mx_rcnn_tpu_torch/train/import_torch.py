"""Seed the backbone from a torchvision-layout ResNet ``.pth`` (port of the
ResNet half of ``mx_rcnn_tpu/train/import_torch.py``).

The reference's training scripts call ``load_param`` on ImageNet weights before
training; torch users hold ``resnet50/101-*.pth`` state_dicts instead.
Their keys map onto the port's ``backbone`` modules: convolution weights
(OIHW on both sides, so no transpose) into parameters, and BN ``weight``,
``bias``, ``running_mean``, ``running_var`` into the FrozenBN buffers
``scale``, ``bias``, ``mean``, ``var``.  Keys of the file that name nothing
in the model (``fc.*``, ``num_batches_tracked``, blocks a shallower
backbone lacks) are skipped.  The VGG-16 mapping waits for the VGG
backbone.  The file must already be on disk: nothing is fetched.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import torch

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_BLOCK = re.compile(r"layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\.(\w+)$")
_STEM = re.compile(r"(conv1|bn1)\.(\w+)$")


def _module_key(module: str, leaf: str) -> Optional[str]:
    """``conv*``/``bn*``/``downsample.{0,1}`` + a torchvision leaf -> the
    port's ``<module>.<leaf>``, or None when the leaf maps to nothing."""
    if module in ("downsample.0", "downsample.1"):
        module = "downsample_conv" if module.endswith("0") else "downsample_bn"
    if "conv" in module:
        return f"{module}.weight" if leaf == "weight" else None
    return f"{module}.{_BN[leaf]}" if leaf in _BN else None


def map_torch_resnet(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A torchvision ResNet state_dict -> ``{port backbone key: float32
    tensor}`` (``backbone.layer2_block0.conv1.weight``, ...).  Works for
    ResNet-50/101/152: the blocks are read from the keys."""
    out = {}
    for key, value in state_dict.items():
        m = _BLOCK.match(key)
        if m:
            layer, block, module, leaf = m.groups()
            name = _module_key(module, leaf)
            prefix = f"backbone.layer{layer}_block{block}"
        else:
            m = _STEM.match(key)
            if not m:
                continue  # fc.* and anything else of the classifier
            name = _module_key(*m.groups())
            prefix = "backbone"
        if name is not None:
            out[f"{prefix}.{name}"] = value.detach().to("cpu", torch.float32)
    return out


def load_pretrained_backbone(variables: dict[str, torch.Tensor],
                             pth_path: str) -> dict[str, torch.Tensor]:
    """A copy of the state_dict ``variables`` whose backbone tensors the
    torchvision ``.pth`` at ``pth_path`` provides (``weights_only`` load).
    Only keys present in both are copied; a shape mismatch raises, and so
    does a file that matches nothing (a wrong-architecture file must not
    pass for random init)."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    mapped = map_torch_resnet(sd)
    out = dict(variables)
    consumed = 0
    for key, value in mapped.items():
        if key not in out:
            continue
        if tuple(out[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {tuple(value.shape)} vs "
                             f"model {tuple(out[key].shape)}")
        out[key] = value.to(out[key].dtype)
        consumed += 1
    if consumed == 0:
        raise ValueError(f"{pth_path} matched no tensor of the model's backbone; "
                         "checkpoint/backbone architecture mismatch")
    return out
