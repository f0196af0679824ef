"""VGG-16 trunk (port of ``mx_rcnn_tpu/models/vgg.py``).

conv1_1..conv5_3: 13 3x3 convolutions with bias and ReLU in five groups,
a 2x2/2 max-pool after groups 1-4 and no pool5, so conv5_3 has stride 16
and is returned as level 4, the key ResNet's C4 has: the C4 recipe reads
one feature map whichever trunk made it.  Parameters are named
``group{g}.conv{g}_{c}`` like the flax modules.  ``remat``: while grad
is enabled each group's convolutions run under ``torch.utils.checkpoint``
(non-reentrant) and are recomputed in the backward pass; the pools stay
outside, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mx_rcnn_tpu_torch.models.layers import Conv2d

VGG16_GROUPS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(nn.Module):
    """images (N, 3, H, W) -> {4: conv5_3 (N, 512, H/16, W/16)}."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, device=None,
                 remat: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        cin = 3
        for g, (ch, n_convs) in enumerate(VGG16_GROUPS, start=1):
            group = nn.Module()
            for c in range(1, n_convs + 1):
                group.add_module(f"conv{g}_{c}", Conv2d(cin, ch, 3, dtype=dtype, device=device))
                cin = ch
            self.add_module(f"group{g}", group)

    @staticmethod
    def _group(group: nn.Module, x: torch.Tensor) -> torch.Tensor:
        for conv in group.children():
            x = F.relu(conv(x))
        return x

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        x = x.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for g in range(1, len(VGG16_GROUPS) + 1):
            group = getattr(self, f"group{g}")
            if remat:
                x = checkpoint(self._group, group, x, use_reentrant=False)
            else:
                x = self._group(group, x)
            if g < len(VGG16_GROUPS):
                x = F.max_pool2d(x, 2, 2)
        return {4: x}
