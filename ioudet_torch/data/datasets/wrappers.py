"""Dataset wrappers (counterpart of ``ioudet/data/datasets/wrappers.py``)."""

from __future__ import annotations

import bisect

import numpy as np


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()
        self.CLASSES = self.datasets[0].CLASSES
        self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[ds - 1] if ds > 0 else 0)
        return self.datasets[ds][off]


class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        self.flag = np.tile(dataset.flag, times)
        self._ori_len = len(dataset)

    def __len__(self):
        return self.times * self._ori_len

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]
