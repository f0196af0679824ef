from mx_rcnn_tpu_torch.models.build import backbone_channels, build_backbone
from mx_rcnn_tpu_torch.models.fpn import FPN
from mx_rcnn_tpu_torch.models.heads import BoxHead, MaskHead, RPNHead
from mx_rcnn_tpu_torch.models.resnet import ResNet
from mx_rcnn_tpu_torch.models.vgg import VGG16

__all__ = ["BoxHead", "FPN", "MaskHead", "RPNHead", "ResNet", "VGG16", "backbone_channels",
           "build_backbone"]
