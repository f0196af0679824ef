"""The assembled two-stage detector (port of
``mx_rcnn_tpu/detection/detector.py``).

Owns the parameterized pieces (backbone, FPN, heads); the parameter-free
detection logic lives in :mod:`mx_rcnn_tpu_torch.detection.graph`.  Every
public method takes and returns the JAX package's NHWC layout; inside,
activations are NCHW views of ``channels_last`` memory, the same bytes.
"""

from __future__ import annotations

import torch
from torch import nn

from mx_rcnn_tpu_torch.config import ModelConfig
from mx_rcnn_tpu_torch.models import FPN, BoxHead, RPNHead, build_backbone
from mx_rcnn_tpu_torch.utils.precision import policy_of


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view of the same (channels_last) memory."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class TwoStageDetector(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        if not cfg.fpn.enabled:
            raise NotImplementedError("single-level (C4) models are not ported")
        self.cfg = cfg
        policy = policy_of(cfg)
        dtype, out_dtype = policy.compute_dtype, policy.output_dtype
        self.backbone = build_backbone(cfg.backbone, dtype, device)
        self.fpn = FPN(cfg.fpn.channels, cfg.fpn.min_level, cfg.fpn.max_level,
                       dtype=dtype, device=device)
        self.rpn_head = RPNHead(
            cfg.anchors.num_anchors(), cfg.fpn.channels, cfg.rpn.channels,
            dtype=dtype, out_dtype=out_dtype, device=device,
        )
        s = cfg.rcnn.pooled_size
        self.box_head = BoxHead(
            cfg.num_classes, s * s * cfg.fpn.channels, cfg.rcnn.hidden_dim,
            cfg.rcnn.class_agnostic, dtype=dtype, out_dtype=out_dtype,
            device=device,
        )

    @property
    def feature_levels(self) -> tuple[int, ...]:
        """Levels the RPN sees (stride of level l is 2**l)."""
        return tuple(range(self.cfg.fpn.min_level, self.cfg.fpn.max_level + 1))

    @property
    def roi_levels(self) -> tuple[int, ...]:
        """Levels ROIAlign reads (P6 is RPN-only)."""
        return tuple(range(self.cfg.fpn.min_level, min(self.cfg.fpn.max_level, 5) + 1))

    def features(self, images: torch.Tensor) -> dict[int, torch.Tensor]:
        """images (B, H, W, 3) normalized -> {level: (B, H_l, W_l, C)},
        contiguous NHWC for the levels ROIAlign reads."""
        feats = self.fpn(self.backbone(_nchw(images.contiguous())))
        out = {}
        for lvl, f in feats.items():
            f = _nhwc(f)
            out[lvl] = f.contiguous() if lvl in self.roi_levels else f
        return out

    def rpn(self, feats: dict[int, torch.Tensor]):
        """{level: (logits (B, A_l), deltas (B, A_l, 4))}, one weight-shared
        head applied per level."""
        return {l: self.rpn_head(_nchw(feats[l])) for l in sorted(feats)}

    def box(self, pooled: torch.Tensor):
        """pooled (R, S, S, C) -> (cls_logits (R, C), deltas (R, C or 1, 4))."""
        return self.box_head(pooled)
