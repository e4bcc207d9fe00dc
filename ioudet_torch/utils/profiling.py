"""Profiling helpers (counterpart of ``ioudet/utils/profiling.py``): a
``torch.profiler`` trace of a block and a step timer whose clock stops only
when the device has finished."""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, activities: Optional[list] = None):
    """Profile the block (host and, where there is a card, device) and write
    a Chrome trace to ``log_dir/trace.json``; yields the profiler, whose
    ``key_averages()`` sum the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile
    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def synchronize(device=None) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


def time_fn(fn: Callable, args: tuple = (), iters: int = 20, warmup: int = 3,
            device=None) -> dict:
    """Wall time of ``fn(*args)``, each call ending in a device sync:
    ``{median_s, mean_s, per_sec}`` over ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn(*args)
        synchronize(device)
        times.append(time.perf_counter() - t)
    median = statistics.median(times)
    return dict(median_s=median, mean_s=statistics.fmean(times), per_sec=1.0 / median)
