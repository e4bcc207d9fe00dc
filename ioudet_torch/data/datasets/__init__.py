from .coco import CocoDataset
from .custom import CustomDataset
from .wrappers import ConcatDataset, RepeatDataset

__all__ = ["CocoDataset", "CustomDataset", "ConcatDataset", "RepeatDataset"]
