"""RPN, box and mask heads (port of ``mx_rcnn_tpu/models/heads.py``).

The RPN head runs once per level (the JAX package's ``RPNHead.packed`` is
a TPU repacking of the same computation and is not carried over).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mx_rcnn_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Dense


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int, cin: int = 256, channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.out_dtype = out_dtype
        kw = dict(dtype=dtype, device=device)
        self.conv = Conv2d(cin, channels, 3, **kw)
        self.objectness = Conv2d(channels, num_anchors, 1, **kw)
        self.deltas = Conv2d(channels, num_anchors * 4, 1, **kw)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, C, H, W) -> logits (B, H*W*A), deltas (B, H*W*A, 4),
        flattened (H, W, A) row-major like the anchors."""
        y = F.relu(self.conv(x))
        b = x.shape[0]
        logits = self.objectness(y).permute(0, 2, 3, 1).reshape(b, -1)
        deltas = self.deltas(y).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits.to(self.out_dtype), deltas.to(self.out_dtype)


class BoxHead(nn.Module):
    def __init__(self, num_classes: int, in_features: int, hidden_dim: int = 1024,
                 class_agnostic: bool = False, dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.out_dtype = out_dtype
        self.n_reg = 1 if class_agnostic else num_classes
        kw = dict(dtype=dtype, device=device)
        self.fc6 = Dense(in_features, hidden_dim, **kw)
        self.fc7 = Dense(hidden_dim, hidden_dim, **kw)
        self.cls_score = Dense(hidden_dim, num_classes, **kw)
        self.bbox_pred = Dense(hidden_dim, self.n_reg * 4, **kw)

    def forward(self, rois: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """rois (R, S, S, C) pooled NHWC -> logits (R, num_classes), deltas
        (R, num_classes or 1, 4).  Flattening is (S, S, C) like flax."""
        r = rois.shape[0]
        x = F.relu(self.fc6(rois.reshape(r, -1)))
        x = F.relu(self.fc7(x))
        logits = self.cls_score(x)
        deltas = self.bbox_pred(x).reshape(r, self.n_reg, 4)
        return logits.to(self.out_dtype), deltas.to(self.out_dtype)


class MaskHead(nn.Module):
    """Mask R-CNN's head: ``num_convs`` 3x3 convs + ReLU, a 2x2 stride-2
    deconv + ReLU, a 1x1 conv to ``num_classes`` mask logits."""

    def __init__(self, num_classes: int, cin: int = 256, channels: int = 256,
                 num_convs: int = 4, dtype: torch.dtype = torch.bfloat16,
                 out_dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.out_dtype = out_dtype
        self.num_convs = num_convs
        kw = dict(dtype=dtype, device=device)
        for i in range(num_convs):
            setattr(self, f"conv{i + 1}", Conv2d(cin if i == 0 else channels, channels, 3, **kw))
        self.deconv = ConvTranspose2d(channels, channels, 2, **kw)
        self.mask_logits = Conv2d(channels, num_classes, 1, **kw)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        """rois (R, S, S, C) pooled NHWC -> (R, 2S, 2S, num_classes) mask
        logits, NHWC."""
        x = rois.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.mask_logits(x).permute(0, 2, 3, 1).to(self.out_dtype)
