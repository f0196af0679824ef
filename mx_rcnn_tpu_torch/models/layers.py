"""Convolution and dense layers with float32 master weights.

Each layer keeps its parameters in float32 and casts them to its compute
dtype at every call, as flax's ``dtype=`` modules do; the input is cast
too.  Convolution weights live in ``channels_last`` memory, so a conv on
an NHWC activation (an NCHW view of channels_last memory) needs no layout
copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Module):
    """k x k convolution, symmetric padding k // 2, weight (O, I, k, k)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.stride = stride
        self.padding = k // 2
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(cout, cin, k, k, device=device).to(
                memory_format=torch.channels_last
            )
        )
        self.bias = (
            nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x.to(self.dtype), self.weight.to(self.dtype), b,
            stride=self.stride, padding=self.padding,
        )


class ConvTranspose2d(nn.Module):
    """k x k transposed convolution at stride k (no overlap, output k x the
    input), weight (I, O, k, k) as ``torch.nn.ConvTranspose2d`` keeps it:
    flax's ``ConvTranspose`` kernel is the same taps flipped in both
    spatial axes (``weights.py`` converts)."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.stride = k
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(cin, cout, k, k, device=device).to(memory_format=torch.channels_last)
        )
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=self.stride,
        )


class Dense(nn.Module):
    """y = x W^T + b with W (out, in)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )
