from .assigners import ApproxMaxIoUAssigner, AssignResult, MaxIoUAssigner, assign_max_iou
from .geometry import bbox_overlaps
from .transforms import (bbox2delta, bbox2result, bbox_flip, bbox_mapping, bbox_mapping_back,
                         delta2bbox, distance2bbox)

__all__ = ["ApproxMaxIoUAssigner", "AssignResult", "MaxIoUAssigner", "assign_max_iou", "bbox_overlaps",
           "bbox2delta", "bbox2result", "bbox_flip", "bbox_mapping", "bbox_mapping_back",
           "delta2bbox", "distance2bbox"]
