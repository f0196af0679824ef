"""Frozen batch norm (port of ``mx_rcnn_tpu/models/norm.py``).

A pure affine whose four float32 tensors are buffers, never parameters:
``y = x * mul + add`` with ``mul = scale / sqrt(var + eps)`` and
``add = bias - mean * scale / sqrt(var + eps)`` computed in float32 and
cast once to the compute dtype, as the flax module does.
"""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm(nn.Module):
    eps = 1e-5

    def __init__(self, channels: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=torch.float32, device=device)
        self.register_buffer("scale", torch.ones(channels, **kw))
        self.register_buffer("bias", torch.zeros(channels, **kw))
        self.register_buffer("mean", torch.zeros(channels, **kw))
        self.register_buffer("var", torch.ones(channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W), any memory format."""
        root = torch.sqrt(self.var + self.eps)
        mul = (self.scale / root).to(self.dtype)
        add = (self.bias - self.mean * self.scale / root).to(self.dtype)
        return x * mul[:, None, None] + add[:, None, None]
