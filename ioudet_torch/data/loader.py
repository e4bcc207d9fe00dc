"""Batched loading (counterpart of ``ioudet/data/loader.py``).

  * samples are fixed-shape numpy dicts, so ``collate`` is a stack;
  * ``GroupedBatchSampler`` batches within one orientation group (one
    canvas per batch), rounds each group up to whole batches by drawing
    again within it, and shuffles from (seed, epoch);
  * ``DataLoader`` fetches samples on a thread pool with a bounded prefetch
    queue, each under the random stream of its (seed, epoch, index)
    (``rng.py``), so a run does not depend on the worker count.  A
    sample's exception reaches the consumer.
  * data parallel: the batch list is padded to a multiple of the shard
    count by drawing batches again and dealt out round-robin, one shard a
    rank (the shard count and index default to the ``torch.distributed``
    world and rank).  Batches stay numpy; the consumer pins them and copies
    them to its device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import rank, world_size
from .rng import clear_sample_rng, make_sample_rng, set_sample_rng


def collate(samples) -> dict:
    """Stack a list of fixed-shape sample dicts into one batch dict."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


def _shards(num_shards: Optional[int], shard_index: Optional[int]) -> tuple:
    """(count, index): as given, else the process group's world and rank."""
    if num_shards is None:
        return world_size(), rank()
    return num_shards, shard_index or 0


class GroupedBatchSampler:
    """Index lists of ``batch_size``, each from one orientation group; of
    ``num_shards`` shards, the ``shard_index``-th."""

    def __init__(self, flags: np.ndarray, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 num_shards: Optional[int] = None, shard_index: Optional[int] = None):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.num_shards, self.shard_index = _shards(num_shards, shard_index)
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(f"shard {self.shard_index} of {self.num_shards}")

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[list]:
        rng = np.random.default_rng(self.seed + self.epoch)
        batches = []
        for g in np.unique(self.flags):
            idxs = np.where(self.flags == g)[0]
            if self.shuffle:
                idxs = rng.permutation(idxs)
            pad = (-len(idxs)) % self.batch_size
            if pad and not self.drop_last:
                # unshuffled, the group's first images again, cyclically:
                # ioudet's idxs[:pad] loses a group of fewer than pad images
                extra = rng.choice(idxs, pad) if self.shuffle else np.resize(idxs, pad)
                idxs = np.concatenate([idxs, extra])
            for b in range(len(idxs) // self.batch_size):
                batches.append(idxs[b * self.batch_size:(b + 1) * self.batch_size].tolist())
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        # every rank takes the same number of steps, or the gradient
        # all-reduce waits for ever: batches drawn again fill the last round
        pad = (-len(batches)) % self.num_shards
        if pad and batches:
            extra = rng.integers(0, len(batches), pad) if self.shuffle \
                else np.arange(pad) % len(batches)
            batches += [batches[int(i)] for i in extra]
        return iter(batches[self.shard_index::self.num_shards])

    def __len__(self):
        total = 0
        for g in np.unique(self.flags):
            n = int((self.flags == g).sum())
            total += n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return -(-total // self.num_shards)


class _Failed:
    def __init__(self, error: BaseException):
        self.error = error


class DataLoader:
    """Prefetching loader over a map-style dataset; ``num_shards`` /
    ``shard_index`` as ``GroupedBatchSampler``'s."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 4, num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        flags = getattr(dataset, "flag", np.zeros(len(dataset), np.uint8))
        self.sampler = GroupedBatchSampler(flags, batch_size, shuffle, seed, drop_last,
                                           num_shards, shard_index)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()
        seed, epoch = self.sampler.seed, self.sampler.epoch

        def fetch(idx):
            set_sample_rng(make_sample_rng(seed, epoch, int(idx)))
            try:
                return self.dataset[int(idx)]
            finally:
                clear_sample_rng()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            end = done
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idxs in self.sampler:
                        if stop.is_set() or not put(collate(list(pool.map(fetch, batch_idxs)))):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                end = _Failed(e)
            finally:
                put(end)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()   # an abandoned iterator stops fetching


def to_device(array, device: torch.device) -> torch.Tensor:
    """A batch entry (numpy or tensor) on ``device``; to a card from host
    memory through a pinned copy, so that the copy does not wait on the
    host."""
    t = torch.as_tensor(np.ascontiguousarray(array) if isinstance(array, np.ndarray) else array)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def build_dataloader(dataset, imgs_per_gpu: int, workers_per_gpu: int = 2,
                     num_gpus: int = 1, shuffle: bool = True, seed: int = 0,
                     **kwargs) -> DataLoader:
    """``imgs_per_gpu * num_gpus`` images a batch; without ``drop_last``
    given, a shuffled (training) loader drops the ragged tail.  A rank of a
    process group loads its own shard (``num_shards`` / ``shard_index`` in
    ``kwargs`` say otherwise)."""
    kwargs.setdefault("drop_last", shuffle)
    return DataLoader(dataset, batch_size=imgs_per_gpu * num_gpus, shuffle=shuffle,
                      num_workers=workers_per_gpu * num_gpus, seed=seed, **kwargs)
