"""Detection evaluation on the host, in numpy (port of
``mx_rcnn_tpu/evalutil``): the COCO and VOC evaluators, the eval loop
(:func:`pred_eval`, sharded and resumable), the detection dump, the
submission files, mask paste and RLE, and drawing."""

from mx_rcnn_tpu_torch.evalutil.coco_eval import CocoEvaluator
from mx_rcnn_tpu_torch.evalutil.detections import (
    detections_from_json,
    load_detections,
    save_detections,
)
from mx_rcnn_tpu_torch.evalutil.pred_eval import (
    collect_detections,
    collect_detections_sharded,
    evaluate_detections,
    merge_detection_shards,
    pred_eval,
)
from mx_rcnn_tpu_torch.evalutil.submission import (
    read_coco_results,
    read_voc_dets,
    write_coco_results,
    write_voc_dets,
)
from mx_rcnn_tpu_torch.evalutil.voc_eval import voc_ap, voc_eval

__all__ = [
    "CocoEvaluator",
    "collect_detections",
    "collect_detections_sharded",
    "detections_from_json",
    "evaluate_detections",
    "load_detections",
    "merge_detection_shards",
    "pred_eval",
    "read_coco_results",
    "read_voc_dets",
    "save_detections",
    "voc_ap",
    "voc_eval",
    "write_coco_results",
    "write_voc_dets",
]
