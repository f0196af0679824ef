"""Backbone factory (port of ``mx_rcnn_tpu/models/build.py``)."""

from __future__ import annotations

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import BackboneConfig
from mx_rcnn_tpu_torch.models.resnet import STAGE_BLOCKS, STAGE_CHANNELS, ResNet
from mx_rcnn_tpu_torch.models.vgg import VGG16, VGG16_GROUPS


def backbone_channels(cfg: BackboneConfig, level: int) -> int:
    """Channels of the backbone's output at ``level``."""
    if cfg.name == "vgg16":
        return VGG16_GROUPS[-1][0]
    return STAGE_CHANNELS[level]


def build_backbone(cfg: BackboneConfig, dtype: torch.dtype, device=None,
                   out_levels: tuple[int, ...] = (2, 3, 4, 5)) -> nn.Module:
    """``dtype`` is the resolved policy's compute dtype; ``out_levels``
    the ResNet stages returned (VGG returns conv5_3 as level 4).  The
    ResNet takes ``cfg.norm`` after each convolution; VGG-16 has no norm
    and ignores it, as the JAX package does.  Both take ``cfg.remat``."""
    if cfg.name in STAGE_BLOCKS:
        return ResNet(STAGE_BLOCKS[cfg.name], dtype=dtype, device=device, out_levels=out_levels,
                      norm=cfg.norm, remat=cfg.remat)
    if cfg.name == "vgg16":
        return VGG16(dtype=dtype, device=device, remat=cfg.remat)
    raise ValueError(f"unknown backbone {cfg.name!r}")
