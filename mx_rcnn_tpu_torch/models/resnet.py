"""ResNet-50/101 backbone (port of ``mx_rcnn_tpu/models/resnet.py``).

Canonical form only: the 7x7/2 stem conv, a 3x3/2 max-pool with -inf
padding, and bottleneck-v1 blocks (stride in the 3x3 conv, projection
shortcut on shape change), each conv followed by a frozen BN.  The JAX
package's TPU rewrites (space-to-depth stem, slice-max pool, C2 lane
padding, BN folding) compute the same function over the same parameter
tree and are not carried over.

Activations are NCHW views of ``channels_last`` memory, which is the
JAX package's NHWC layout in memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import Conv2d
from mx_rcnn_tpu_torch.models.norm import FrozenBatchNorm

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4), projection shortcut on shape change."""

    def __init__(self, cin: int, channels: int, stride: int,
                 dtype: torch.dtype, device=None) -> None:
        super().__init__()
        out = channels * 4
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(cin, channels, 1, 1, bias=False, **kw)
        self.bn1 = FrozenBatchNorm(channels, **kw)
        self.conv2 = Conv2d(channels, channels, 3, stride, bias=False, **kw)
        self.bn2 = FrozenBatchNorm(channels, **kw)
        self.conv3 = Conv2d(channels, out, 1, 1, bias=False, **kw)
        self.bn3 = FrozenBatchNorm(out, **kw)
        self.downsample_conv = self.downsample_bn = None
        if cin != out or stride != 1:
            self.downsample_conv = Conv2d(cin, out, 1, stride, bias=False, **kw)
            self.downsample_bn = FrozenBatchNorm(out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """images (N, 3, H, W) -> {2: C2, 3: C3, 4: C4, 5: C5}."""

    def __init__(self, blocks=STAGE_BLOCKS["resnet50"],
                 dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, bias=False, dtype=dtype, device=device)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype, device=device)
        self.block_names: list[list[str]] = []
        cin = 64
        for i, (n_blocks, width) in enumerate(zip(blocks, (64, 128, 256, 512))):
            names = []
            for b in range(n_blocks):
                name = f"layer{i + 1}_block{b}"
                stride = 2 if (i > 0 and b == 0) else 1
                self.add_module(
                    name, Bottleneck(cin, width, stride, dtype, device)
                )
                cin = width * 4
                names.append(name)
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for i, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x)
            feats[i + 2] = x
        return feats
