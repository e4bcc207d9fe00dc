from .bbox_overlaps import bbox_overlaps_np
from .class_names import (COCO_CLASSES, VOC_CLASSES, coco_classes, get_classes,
                          voc_classes)
from .coco_eval import (CocoEvaluator, coco_eval_results, iou_xywh,
                        print_coco_summary, xyxy2xywh)
from .mean_ap import average_precision, eval_map, print_map_summary, tpfp_default
from .recall import eval_recalls

__all__ = [
    "bbox_overlaps_np", "COCO_CLASSES", "VOC_CLASSES", "coco_classes",
    "voc_classes", "get_classes", "CocoEvaluator", "coco_eval_results",
    "print_coco_summary", "xyxy2xywh", "iou_xywh", "eval_map",
    "average_precision", "tpfp_default", "print_map_summary", "eval_recalls",
]
