"""The data pipeline (counterpart of ``ioudet/data``): datasets, pipeline
steps, the loader.  Numpy only: no image library, no JAX."""

from .builder import DATASETS, build_dataset
from .datasets import CocoDataset, ConcatDataset, CustomDataset, RepeatDataset
from .loader import DataLoader, GroupedBatchSampler, build_dataloader, collate
from .pipelines import PIPELINES, Compose

__all__ = ["DATASETS", "PIPELINES", "build_dataset", "CocoDataset", "ConcatDataset",
           "CustomDataset", "RepeatDataset", "DataLoader", "GroupedBatchSampler",
           "build_dataloader", "collate", "Compose"]
