from .geometry import bbox_overlaps
from .transforms import bbox2delta, bbox2result, delta2bbox

__all__ = ["bbox_overlaps", "bbox2delta", "bbox2result", "delta2bbox"]
