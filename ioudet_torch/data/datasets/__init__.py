from .coco import CocoDataset
from .custom import CustomDataset
from .wrappers import ConcatDataset, RepeatDataset
from .xml_style import VOCDataset, WIDERFaceDataset, XMLDataset

__all__ = ["CocoDataset", "CustomDataset", "ConcatDataset", "RepeatDataset", "VOCDataset",
           "WIDERFaceDataset", "XMLDataset"]
