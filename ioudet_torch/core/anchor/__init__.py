from .anchor_generator import AnchorGenerator
from .anchor_target import (AnchorTargets, anchor_inside_flags, anchor_target,
                            anchor_target_single, images_to_levels)

__all__ = ["AnchorGenerator", "AnchorTargets", "anchor_inside_flags",
           "anchor_target", "anchor_target_single", "images_to_levels"]
