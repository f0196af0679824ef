"""Seed the backbone from a torchvision-layout ResNet or VGG-16 ``.pth``
(port of ``mx_rcnn_tpu/train/import_torch.py``).

The reference's training scripts call ``load_param`` on ImageNet weights before
training; torch users hold ``resnet50/101-*.pth`` state_dicts instead.
Their keys map onto the port's ``backbone`` modules: convolution weights
(OIHW on both sides, so no transpose) into parameters, and BN ``weight``,
``bias``, ``running_mean``, ``running_var`` into the FrozenBN buffers
``scale``, ``bias``, ``mean``, ``var``.  Under ``backbone.norm`` ``bn`` or
``gn`` only the convolutions load and every norm keeps its init, as in
the JAX package (its importer merges the BN tensors into a ``constants``
collection those models do not have).  Keys of the file that name nothing
in the model (``fc.*``, ``num_batches_tracked``, blocks a shallower
backbone lacks) are skipped.  A VGG-16 file (cfg D, no BN; told apart by
``features.0.weight``) maps its 13 convolutions onto ``backbone.group*``
and the classifier's first two layers onto the box head's ``fc6`` and
``fc7``, as the reference's VGG recipe seeds them.  The file must already
be on disk: nothing is fetched.
"""

from __future__ import annotations

import logging
import re
from typing import Mapping, Optional

import torch

log = logging.getLogger("mx_rcnn_tpu_torch.import_torch")

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_BLOCK = re.compile(r"layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.[01])\.(\w+)$")
_STEM = re.compile(r"(conv1|bn1)\.(\w+)$")
# A port key of a norm module (``backbone.bn1.scale``,
# ``backbone.layer1_block0.downsample_bn.var``).
_NORM_KEY = re.compile(r"\.(bn\d|downsample_bn)\.\w+$")


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


# torchvision cfg-D ``features`` indices of the 13 convolutions, by group.
_VGG16_CONV_LAYERS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def map_torch_vgg16(state_dict: Mapping[str, torch.Tensor]
                    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """A torchvision VGG-16 state_dict -> (backbone tensors, box-head
    tensors), keyed as the port's state_dict (``backbone.group1.conv1_1.
    weight``, ``box_head.fc6.weight``).  The head is empty when the file
    has no classifier.  Raises on another VGG variant (vgg16_bn, vgg11,
    vgg13) before mapping anything."""
    for layers in _VGG16_CONV_LAYERS:
        for idx in layers:
            key = f"features.{idx}.weight"
            v = state_dict.get(key)
            if v is None or v.dim() != 4:
                raise ValueError("unsupported torchvision VGG variant: expected vgg16 "
                                 f"(cfg D, no BN); {key} missing or not a conv kernel")

    def f32(key: str) -> torch.Tensor:
        return state_dict[key].detach().to("cpu", torch.float32)

    backbone = {}
    for g, layers in enumerate(_VGG16_CONV_LAYERS, start=1):
        for i, idx in enumerate(layers, start=1):
            for leaf in ("weight", "bias"):
                backbone[f"backbone.group{g}.conv{g}_{i}.{leaf}"] = f32(f"features.{idx}.{leaf}")
    head = {}
    if "classifier.0.weight" in state_dict:
        # torch flattens the pool (C, H, W), the box head its pooled rois
        # (H, W, C): permute fc6's input axis.  512x7x7 is the architecture's.
        w6 = f32("classifier.0.weight")
        head["box_head.fc6.weight"] = (w6.reshape(w6.shape[0], 512, 7, 7).permute(0, 2, 3, 1)
                                       .reshape(w6.shape[0], -1).contiguous())
        head["box_head.fc6.bias"] = f32("classifier.0.bias")
        head["box_head.fc7.weight"] = f32("classifier.3.weight")
        head["box_head.fc7.bias"] = f32("classifier.3.bias")
    return backbone, head


def load_pretrained_backbone(variables: dict[str, torch.Tensor], pth_path: str,
                             norm: str = "frozen_bn") -> dict[str, torch.Tensor]:
    """A copy of the state_dict ``variables`` whose backbone tensors (and,
    for VGG-16, the box head's ``fc6``/``fc7``) the torchvision ``.pth``
    at ``pth_path`` provides (``weights_only`` load).  ``norm``: the
    model's ``backbone.norm``; the file's BN tensors load only into
    FrozenBN.  Only keys present
    in both are copied; a backbone shape mismatch raises, and so does a
    file that matches nothing (a wrong-architecture file must not pass for
    random init).  A box head of other dimensions than the classifier's
    keeps its random init, with a warning."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if "features.0.weight" in sd:
        mapped, head = map_torch_vgg16(sd)
    else:
        mapped, head = map_torch_resnet(sd), {}
        if norm != "frozen_bn":
            mapped = {k: v for k, v in mapped.items() if not _NORM_KEY.search(k)}
    if head:
        if all(k in variables and variables[k].shape == v.shape for k, v in head.items()):
            mapped.update(head)
        else:
            log.warning("box head dims differ from the VGG classifier (hidden_dim != 4096 or "
                        "pooled != 7x7x512); fc6/fc7 keep random init — expect lower VOC mAP "
                        "than the baseline")
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
