from mx_rcnn_tpu_torch.geometry.anchors import (
    generate_base_anchors,
    shifted_anchors_np,
)
from mx_rcnn_tpu_torch.geometry.boxes import (
    BBOX_XFORM_CLIP,
    SNAP_BITS,
    area,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    ioa_matrix,
    iou_matrix,
    snap,
    valid_box_mask,
)

__all__ = [
    "BBOX_XFORM_CLIP",
    "SNAP_BITS",
    "area",
    "clip_boxes",
    "decode_boxes",
    "encode_boxes",
    "generate_base_anchors",
    "ioa_matrix",
    "iou_matrix",
    "shifted_anchors_np",
    "snap",
    "valid_box_mask",
]
