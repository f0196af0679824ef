"""Immutable configuration for the PyTorch port.

A copy of the subset of ``mx_rcnn_tpu/config.py`` that the serving path,
the single-device train step and evaluation read, with the same field
names and defaults, so a ``--set``-style override string means the same
thing to both packages.  Fields the port does not read (multi-chip
layout, TPU layout rewrites such as ``stem_s2d``/``c2_pad``/
``packed_head``/``fold_frozen_bn``, speed-only knobs such as
``assign_block``/``topk_block``/``roi_block``/``topk_impl`` whose forms
are bit-identical to the dense or stable ones the port computes, the
observability and fleet planes) are left out; the port always executes
the canonical forms.

Two backend knobs keep their JAX-side values so a config reads the same in
both packages: ``"pallas"`` selects the port's hand-written CUDA kernel
(the replacement of the Pallas kernel of that name), ``"xla"`` the plain
PyTorch path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class AnchorConfig:
    scales: tuple[float, ...] = (8.0, 16.0, 32.0)
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0)

    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "resnet50"  # resnet50 | resnet101 | vgg16
    # Stages to freeze, counted like the reference's fixed_param_prefix
    # (conv1 + res2 frozen for ResNet, groups 1-2 for VGG):
    # train/loop.py::FREEZE_PREFIXES.
    freeze_stages: int = 2
    norm: str = "frozen_bn"
    # Compute dtype for conv/matmul (params stay float32).
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class FPNConfig:
    enabled: bool = True
    channels: int = 256
    min_level: int = 2
    max_level: int = 6  # P6 by stride-2 subsampling of P5 (RPN only)


@dataclass(frozen=True)
class RPNConfig:
    channels: int = 256
    # Anchor labeling (ops/sampling.py::assign_anchors).
    batch_size: int = 256
    fg_fraction: float = 0.5
    positive_iou: float = 0.7
    negative_iou: float = 0.3
    allowed_border: float = 0.0
    train_pre_nms_top_n: int = 2000
    train_post_nms_top_n: int = 1000
    test_pre_nms_top_n: int = 1000
    test_post_nms_top_n: int = 1000
    nms_threshold: float = 0.7
    min_size: float = 0.0
    # 0 = iterate the plain NMS fixed point to convergence (exact).
    nms_sweep_cap: int = 0
    # Proposal keep-mask backend: "xla" (plain torch fixed point) or
    # "pallas" (the CUDA NMS kernel, ops/cuda/nms.py).
    nms_impl: str = "xla"
    # decode -> clip -> snap -> NMS as one CUDA kernel (ops/cuda/middle.py).
    fused_middle: bool = False
    loss_weight: float = 1.0
    # RPN loss reduction: "dense" over the full (B, A) anchor axis with
    # masks, "compact" over the Q sampled rows (AnchorTargets.sel_*).  The
    # same terms; only the summation order differs.
    loss_impl: str = "dense"


@dataclass(frozen=True)
class RCNNConfig:
    roi_batch_size: int = 512
    fg_fraction: float = 0.25
    fg_iou: float = 0.5
    bg_iou_hi: float = 0.5
    bg_iou_lo: float = 0.0
    bbox_weights: tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    pooled_size: int = 7
    sampling_ratio: int = 2
    hidden_dim: int = 1024
    class_agnostic: bool = False
    # "pallas" = the CUDA ROIAlign kernel (ops/cuda/roi_align.py);
    # "xla" = the plain torch gather.
    roi_align_impl: str = "pallas"
    loss_weight: float = 1.0
    # Backward of the "pallas" forward: "pallas" = the CUDA ROIAlign
    # backward (kernel B2), "xla" = autograd of the plain forward.
    roi_align_bwd_impl: str = "pallas"


@dataclass(frozen=True)
class MaskConfig:
    """The Mask R-CNN branch: ``num_convs`` 3x3 convs of ``channels``, a
    2x2 stride-2 deconv and a 1x1 conv to the classes, on rois pooled at
    ``pooled_size``; gt masks cropped to ``resolution`` (2 x pooled)."""

    enabled: bool = False
    pooled_size: int = 14
    channels: int = 256
    num_convs: int = 4
    resolution: int = 28
    loss_weight: float = 1.0


@dataclass(frozen=True)
class TestConfig:
    # Eval images per call (cli/eval_cli.py's batch).
    per_device_batch: int = 8
    score_threshold: float = 0.05
    nms_threshold: float = 0.5
    max_detections: int = 100
    # "fused": global top-``fused_top_k`` (roi, class) candidates and one
    # class-offset NMS; "per_class": one NMS per foreground class
    # (detection/graph.py::_postprocess_one).
    nms_mode: str = "fused"
    fused_top_k: int = 1000
    nms_sweep_cap: int = 0


@dataclass(frozen=True)
class PrecisionConfig:
    policy: str = "mixed"  # mixed | widen | float32
    accum: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    num_classes: int = 81  # includes background at index 0
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    rcnn: RCNNConfig = field(default_factory=RCNNConfig)
    mask: MaskConfig = field(default_factory=MaskConfig)
    test: TestConfig = field(default_factory=TestConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "coco"  # coco | voc | synthetic
    root: str = "data"
    train_split: str = "train2017"
    val_split: str = "val2017"
    # Static LANDSCAPE canvas (H, W); portrait images letterbox into its
    # transpose (data/transforms.py::oriented_canvas).  800x1344 holds
    # every 800-short / 1333-max resize with FPN stride-32 divisibility.
    image_size: tuple[int, int] = (800, 1344)
    short_side: int = 800
    max_side: int = 1333
    max_gt_boxes: int = 100
    # Horizontal flip augmentation of training batches, one draw an image.
    flip: bool = True
    pixel_mean: tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: tuple[float, float, float] = (58.395, 57.12, 57.375)
    # Training batches hold one orientation each, landscape with landscape
    # and portrait with portrait (data/loader.py::DetectionLoader); a
    # non-square canvas requires it.
    aspect_grouping: bool = True
    # VOC: promote "difficult" objects to real gt instead of ignore regions.
    use_diff: bool = False
    # Parsed-roidb pickle cache (data/datasets.py::_CachedRoidb); "" = off.
    cache_dir: str = ""


@dataclass(frozen=True)
class TenancyConfig:
    """Multi-tenant admission (serve/tenancy.py), read as cfg.serve.tenancy.*;
    host-side only."""

    # Off keeps every admission path and metric series those of the
    # single-tenant engine.
    enabled: bool = False
    # "name:weight=4,rate=50,burst=20,priority=0;name2:..."
    # (serve/tenancy.py::parse_table).
    table: str = ""
    # Where unknown or absent tenant tokens land; shares its bucket and label.
    default_tenant: str = "default"


@dataclass(frozen=True)
class ServeConfig:
    """Serving-engine defaults read by serve/engine.py::build_engine
    (explicit arguments win)."""

    # Static micro-batch slots per device call; >1 enables packing.
    batch_size: int = 1
    # Continuous batching (serve/batcher.py): pack pending requests of
    # different callers into the slots of each call, deadline-aware.  Only
    # meaningful when batch_size > 1.
    pack: bool = True
    # How long the worker lingers for stragglers to top off a partial batch.
    pack_window_s: float = 0.0
    # "inherit" keeps model.rpn as-is; "on" forces fused_middle=True and
    # nms_impl="pallas" for every serving program; "off" forces the plain
    # chain.
    fused_middle: str = "inherit"
    # Per-tenant token-bucket quotas and weighted-fair pack shares.
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)


@dataclass(frozen=True)
class ScheduleConfig:
    """Warmup + MultiFactor decay.  ``decay_steps``/``total_steps`` are
    denominated at a global batch of ``reference_batch`` images and
    rescaled by train/loop.py::scale_schedule_steps; ``reference_batch=0``
    keeps them absolute.  ``warmup_steps`` stays absolute."""

    base_lr: float = 0.02
    warmup_steps: int = 500
    warmup_factor: float = 1.0 / 3.0
    decay_steps: tuple[int, ...] = (60000, 80000)
    factor: float = 0.1
    total_steps: int = 90000
    reference_batch: int = 16


@dataclass(frozen=True)
class TrainConfig:
    per_device_batch: int = 1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip: float = 35.0
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    seed: int = 0
    # Save <workdir>/<name>/ckpt every this many steps, and after the last.
    checkpoint_every: int = 5000
    # Metrics drain (one host transfer, one log line) every this many steps.
    log_every: int = 20
    # NaN guardian (train/guardian.py): rollback-and-skip retries allowed
    # before a non-finite metric becomes a hard TrainingDiverged error.
    # 0 = detect-and-raise immediately (no rollback).
    guardian_rollbacks: int = 2
    # Loss-spike early warning: interval mean this many sigma above the
    # trailing-window mean logs loudly (no rollback, just visibility).
    guardian_spike_z: float = 8.0


@dataclass(frozen=True)
class Config:
    name: str = "faster_rcnn_r50_fpn_coco"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    workdir: str = "runs"


def _c4_model(num_classes: int, backbone: str) -> ModelConfig:
    """Classic C4 recipe: single-level stride-16 features, anchor scales
    (8, 16, 32), ROIAlign on C4, a 2-fc box head."""
    return ModelConfig(
        num_classes=num_classes,
        backbone=BackboneConfig(name=backbone),
        fpn=FPNConfig(enabled=False),
        anchors=AnchorConfig(scales=(8.0, 16.0, 32.0)),
        rpn=RPNConfig(channels=512, train_pre_nms_top_n=6000, train_post_nms_top_n=2000,
                      test_pre_nms_top_n=6000, test_post_nms_top_n=300),
        rcnn=RCNNConfig(roi_batch_size=128),
    )


def _fpn_model(num_classes: int, backbone: str, mask: bool = False) -> ModelConfig:
    return ModelConfig(
        num_classes=num_classes,
        backbone=BackboneConfig(name=backbone),
        fpn=FPNConfig(enabled=True),
        anchors=AnchorConfig(scales=(8.0,)),
        mask=MaskConfig(enabled=mask),
    )


def _vgg16_voc07() -> Config:
    m = _c4_model(21, "vgg16")
    return Config(
        name="vgg16_voc07",
        model=dataclasses.replace(m, rcnn=RCNNConfig(roi_batch_size=128, hidden_dim=4096),
                                  test=dataclasses.replace(m.test, nms_threshold=0.3)),
        data=DataConfig(dataset="voc", train_split="2007_trainval", val_split="2007_test",
                        image_size=(608, 1024), short_side=600, max_side=1000,
                        aspect_grouping=True),
        train=TrainConfig(schedule=ScheduleConfig(base_lr=0.001, decay_steps=(50000,),
                                                  total_steps=70000, warmup_steps=100)),
    )


def _coco(name: str, model: ModelConfig) -> Config:
    return Config(name=name, model=model, train=TrainConfig(per_device_batch=2))


def _tiny_synthetic() -> Config:
    m = _fpn_model(5, "resnet50")
    return Config(
        name="tiny_synthetic",
        model=dataclasses.replace(
            m,
            backbone=dataclasses.replace(m.backbone, freeze_stages=0, dtype="float32"),
            rpn=RPNConfig(batch_size=64, train_pre_nms_top_n=200, train_post_nms_top_n=64,
                          test_pre_nms_top_n=200, test_post_nms_top_n=64),
            rcnn=RCNNConfig(roi_batch_size=32, hidden_dim=128),
            test=TestConfig(per_device_batch=1),
        ),
        data=DataConfig(
            dataset="synthetic", image_size=(128, 128), short_side=128, max_side=128,
            max_gt_boxes=8,
        ),
        train=TrainConfig(
            schedule=ScheduleConfig(base_lr=0.01, warmup_steps=10, decay_steps=(400,),
                                    total_steps=500, reference_batch=0),
            checkpoint_every=250,
        ),
    )


_PRESETS = {
    "vgg16_voc07": _vgg16_voc07,
    "r50_coco": lambda: _coco("r50_coco", _c4_model(81, "resnet50")),
    "r101_coco": lambda: _coco("r101_coco", _c4_model(81, "resnet101")),
    "r101_fpn_coco": lambda: _coco("r101_fpn_coco", _fpn_model(81, "resnet101")),
    "r50_fpn_coco": lambda: _coco("r50_fpn_coco", _fpn_model(81, "resnet50")),
    "mask_r50_fpn_coco": lambda: _coco("mask_r50_fpn_coco",
                                       _fpn_model(81, "resnet50", mask=True)),
    "tiny_synthetic": _tiny_synthetic,
}


def available_configs() -> list[str]:
    return sorted(_PRESETS)


def get_config(name: str, **overrides: Any) -> Config:
    """Build a preset config; kwargs replace top-level Config fields."""
    if name not in _PRESETS:
        raise KeyError(f"unknown config {name!r}; available: {available_configs()}")
    cfg = _PRESETS[name]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _coerce(text: str, current: Any) -> Any:
    """Parse ``text`` to the type of ``current`` (the existing field value)."""
    if isinstance(current, bool):
        if text.lower() in ("1", "true", "yes"):
            return True
        if text.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"expected bool, got {text!r}")
    if isinstance(current, tuple):
        parts = [p for p in text.replace("(", "").replace(")", "").split(",") if p]
        elem = current[0] if current else float("nan")
        return tuple(type(elem)(p) if current else float(p) for p in parts)
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    return text


def apply_overrides(cfg: Config, assignments: list[str]) -> Config:
    """Apply ``dotted.path=value`` overrides to a frozen config tree,
    rebuilding the dataclass spine from the leaf up."""
    for item in assignments:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key.path=value")
        path, text = item.split("=", 1)
        keys = path.strip().split(".")
        nodes = [cfg]
        for k in keys[:-1]:
            nodes.append(getattr(nodes[-1], k))
        leaf = getattr(nodes[-1], keys[-1])
        if dataclasses.is_dataclass(leaf):
            raise ValueError(f"{path} is a config section, not a field")
        new_val = _coerce(text.strip(), leaf)
        for node, k in zip(reversed(nodes), reversed(keys)):
            new_val = dataclasses.replace(node, **{k: new_val})
        cfg = new_val
    return cfg
