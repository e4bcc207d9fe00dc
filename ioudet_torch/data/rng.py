"""Per-sample random streams for pipeline transforms (counterpart of
``ioudet/data/rng.py``).

The loader sets one ``random.Random`` per (seed, epoch, sample index) in a
``threading.local`` around each ``__getitem__``; transforms draw from
``sample_rng()``.  Augmentations are then a function of (seed, epoch, idx)
alone, whatever the worker count or thread interleaving, and the same
integer mix as ``ioudet``'s gives the same draws for the same sample.
Outside a loader, ``sample_rng()`` is the global ``random`` module.
"""

from __future__ import annotations

import random
import threading

_local = threading.local()


def set_sample_rng(rng) -> None:
    _local.rng = rng


def clear_sample_rng() -> None:
    _local.rng = None


def sample_rng():
    """The ambient per-sample stream, or the global ``random`` module."""
    return getattr(_local, "rng", None) or random


def make_sample_rng(seed: int, epoch: int, idx: int) -> random.Random:
    """The stream of one (seed, epoch, idx): a SplitMix-style integer mix, so
    that neighbouring (epoch, idx) pairs land far apart."""
    x = (seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9
         + idx * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return random.Random(x)
