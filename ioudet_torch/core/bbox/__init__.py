from .assigners import AssignResult, MaxIoUAssigner, assign_max_iou
from .geometry import bbox_overlaps
from .transforms import bbox2delta, bbox2result, delta2bbox

__all__ = ["AssignResult", "MaxIoUAssigner", "assign_max_iou", "bbox_overlaps",
           "bbox2delta", "bbox2result", "delta2bbox"]
