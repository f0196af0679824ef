"""Feature Pyramid Network neck (port of ``mx_rcnn_tpu/models/fpn.py``).

1x1 laterals, nearest 2x upsample + add top-down, 3x3 output convs, and
P6 as the stride-2 subsampling of P5 (a 1x1-window max-pool).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import Conv2d
from mx_rcnn_tpu_torch.models.resnet import STAGE_CHANNELS


class FPN(nn.Module):
    def __init__(self, channels: int = 256, min_level: int = 2,
                 max_level: int = 6, dtype: torch.dtype = torch.bfloat16,
                 device=None) -> None:
        super().__init__()
        self.min_level, self.max_level = min_level, max_level
        self.levels = [l for l in (2, 3, 4, 5) if l >= min_level]
        kw = dict(dtype=dtype, device=device)
        for l in self.levels:
            self.add_module(
                f"lateral{l}", Conv2d(STAGE_CHANNELS[l], channels, 1, **kw)
            )
            self.add_module(f"output{l}", Conv2d(channels, channels, 3, **kw))

    def forward(self, feats: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
        laterals = {l: getattr(self, f"lateral{l}")(feats[l]) for l in self.levels}
        top = self.levels[-1]
        merged = {top: laterals[top]}
        for l in reversed(self.levels[:-1]):
            up = F.interpolate(merged[l + 1], scale_factor=2, mode="nearest")
            merged[l] = laterals[l] + up
        out = {l: getattr(self, f"output{l}")(merged[l]) for l in self.levels}
        for l in range(top + 1, self.max_level + 1):
            out[l] = out[l - 1][:, :, ::2, ::2]
        return out
