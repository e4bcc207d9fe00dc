from .bfp import BFP
from .fpn import FPN
from .neck_sequence import NeckSequence

__all__ = ["BFP", "FPN", "NeckSequence"]
