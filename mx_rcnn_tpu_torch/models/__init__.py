from mx_rcnn_tpu_torch.models.build import build_backbone
from mx_rcnn_tpu_torch.models.fpn import FPN
from mx_rcnn_tpu_torch.models.heads import BoxHead, RPNHead
from mx_rcnn_tpu_torch.models.resnet import ResNet

__all__ = ["BoxHead", "FPN", "RPNHead", "ResNet", "build_backbone"]
