"""Backbone factory (port of ``mx_rcnn_tpu/models/build.py``)."""

from __future__ import annotations

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import BackboneConfig
from mx_rcnn_tpu_torch.models.resnet import STAGE_BLOCKS, ResNet


def build_backbone(cfg: BackboneConfig, dtype: torch.dtype, device=None) -> nn.Module:
    """``dtype`` is the resolved policy's compute dtype."""
    if cfg.norm != "frozen_bn":
        raise NotImplementedError(f"backbone.norm={cfg.norm!r} is not ported")
    if cfg.name not in STAGE_BLOCKS:
        raise NotImplementedError(f"backbone {cfg.name!r} is not ported")
    return ResNet(STAGE_BLOCKS[cfg.name], dtype=dtype, device=device)
