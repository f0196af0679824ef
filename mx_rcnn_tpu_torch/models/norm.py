"""Normalization layers (port of ``mx_rcnn_tpu/models/norm.py``).

Every module takes ``x`` (N, C, H, W), any memory format, and returns the
compute dtype it was built with.

* :class:`FrozenBatchNorm` (``frozen_bn``): a pure affine whose four
  float32 tensors are buffers, never parameters: ``y = x * mul + add``
  with ``mul = scale / sqrt(var + eps)`` and ``add = bias - mean * scale /
  sqrt(var + eps)`` computed in float32 and cast once to the compute
  dtype, as the flax module does.
* :class:`BatchNorm` (``bn``): flax's ``BatchNorm(use_running_average=
  True)``.  ``scale`` and ``bias`` are trainable parameters; ``mean`` and
  ``var`` are buffers (flax's ``batch_stats``) that nothing updates.
  Not ``torch.nn.BatchNorm2d``: in train mode that normalizes by the
  batch's statistics and updates the running ones, and JAX does neither.
* :class:`GroupNorm` (``gn``): flax's ``GroupNorm(num_groups=32)``,
  epsilon 1e-6, statistics in float32 by the fast variance
  ``E[x^2] - E[x]^2`` (``F.group_norm`` uses Welford and 1e-5).
* ``none``: ``nn.Identity``.

``bn`` and ``gn`` apply flax's ``_normalize`` in its order:
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, then
one cast to the compute dtype.
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
        root = torch.sqrt(self.var + self.eps)
        mul = (self.scale / root).to(self.dtype)
        add = (self.bias - self.mean * self.scale / root).to(self.dtype)
        return x * mul[:, None, None] + add[:, None, None]


def _normalize(x, mean, var, scale, bias, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax ``_normalize``: mean and var broadcast against x (float32)."""
    mul = torch.rsqrt(var + eps) * scale[:, None, None]
    y = (x.to(torch.float32) - mean) * mul + bias[:, None, None]
    return y.to(dtype)


class BatchNorm(nn.Module):
    eps = 1e-5

    def __init__(self, channels: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))
        self.register_buffer("mean", torch.zeros(channels, **kw))
        self.register_buffer("var", torch.ones(channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(x, self.mean[:, None, None], self.var[:, None, None],
                          self.scale, self.bias, self.eps, self.dtype)


class GroupNorm(nn.Module):
    eps = 1e-6
    groups = 32

    def __init__(self, channels: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        if channels % self.groups:
            raise ValueError(f"Number of groups ({self.groups}) does not divide the number "
                             f"of channels ({channels}).")
        self.dtype = dtype
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(channels, **kw))
        self.bias = nn.Parameter(torch.zeros(channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        size = c // self.groups
        xg = x.to(torch.float32).reshape(n, self.groups, size, h, w)
        mean = xg.mean(dim=(2, 3, 4))
        var = torch.clamp((xg * xg).mean(dim=(2, 3, 4)) - mean * mean, min=0.0)
        per_channel = lambda s: s.repeat_interleave(size, dim=1)[:, :, None, None]  # noqa: E731
        return _normalize(x, per_channel(mean), per_channel(var), self.scale, self.bias,
                          self.eps, self.dtype)


_NORMS = {"frozen_bn": FrozenBatchNorm, "bn": BatchNorm, "gn": GroupNorm}


def make_norm(kind: str, channels: int, dtype: torch.dtype, device=None) -> nn.Module:
    """The ``backbone.norm`` module over ``channels`` channels."""
    if kind == "none":
        return nn.Identity()
    if kind not in _NORMS:
        raise ValueError(f"unknown norm {kind!r}")
    return _NORMS[kind](channels, dtype, device=device)
