from . import rle
from .mask_target import crop_mask_to_roi, mask_target, rasterize_polygons

__all__ = ["rle", "rasterize_polygons", "crop_mask_to_roi", "mask_target"]
