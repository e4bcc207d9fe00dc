"""Data-parallel plumbing (counterpart of ``ioudet/parallel/mesh.py``).

``ioudet`` drives every local chip from one process through a GSPMD mesh.
The port takes PyTorch's idiom instead: one process a card, joined by
``torch.distributed`` and wrapped in ``DistributedDataParallel`` by the
trainer (``apis/train.py``).  There is no mesh object, and ``shard_batch``
has no counterpart: each rank's loader yields only that rank's share of the
global batch (``data/loader.py``, sharded by rank).

  * ``init_dist`` joins the process group that a launcher describes in the
    environment (``torchrun``, or ``tools/train.py --n-devices``);
  * ``rank`` / ``world_size`` / ``local_rank`` read it (0 / 1 / 0 without
    one);
  * ``global_count`` sums a device tensor over the ranks (the losses'
    normalizers, counted over the global batch as ``ioudet`` counts them);
  * ``allgather_pytrees`` gathers one tree of host numpy arrays from every
    rank (the evaluation merge).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 1800.0   # how long a rank waits for the others to join, or in a collective

# the gloo group made over the default group: (default group, gloo group)
_gloo = (None, None)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def global_count(count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the ranks of a process group of more than one
    rank (data-parallel training), else as it is."""
    if world_size() > 1:
        count = count.clone()
        dist.all_reduce(count)
    return count


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_dist(backend: Optional[str] = None,
              device: Union[None, str, torch.device] = None) -> torch.device:
    """Join the process group that ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` describe, as
    ``torchrun`` sets them, and return this rank's device.

    ``device`` defaults to ``cuda:LOCAL_RANK`` where there is a card and to
    the CPU elsewhere, and "cuda" without an index means ``cuda:LOCAL_RANK``;
    a CUDA device without a card raises.  ``backend`` defaults to NCCL on a
    CUDA device and gloo on the CPU.  A process that no launcher started
    (``WORLD_SIZE`` unset) joins nothing; a launcher's world of 1 is a group
    of one.  A failure to join raises: a rank that went on alone would train
    on its share of the data only."""
    if device is None:
        device = f"cuda:{local_rank()}" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        torch.cuda.set_device(device)
    if is_initialized() or "WORLD_SIZE" not in os.environ:
        return device
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        if key not in os.environ:
            raise RuntimeError(f"WORLD_SIZE={os.environ['WORLD_SIZE']}, but {key} is not set")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **kwargs)
    return device


def _gloo_group():
    """The default group where it is gloo's, else a gloo group over the same
    ranks (made once, by every rank, at its first use): host arrays travel
    over gloo whatever the default backend is, since NCCL moves no CPU
    tensors."""
    global _gloo
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if _gloo[0] is not world:
        _gloo = (world, dist.new_group(backend="gloo"))
    return _gloo[1]


def _restore_empty(nodes: list) -> list:
    """The same node of every rank's tree, with an empty ``zeros((0,))`` leaf
    reshaped to the trailing shape of the peer whose leaf is longest."""
    head = nodes[0]
    if isinstance(head, dict):
        cols = [_restore_empty([n[k] for n in nodes]) for k in head]
        return [dict(zip(head, vals)) for vals in zip(*cols)] if cols else nodes
    if isinstance(head, (list, tuple)):
        cols = [_restore_empty([n[i] for n in nodes]) for i in range(len(head))]
        return [type(head)(vals) for vals in zip(*cols)] if cols else nodes
    leaves = [np.asarray(x) for x in nodes]
    if leaves[0].ndim == 0:
        return leaves
    ref = max(leaves, key=len)
    out = []
    for x in leaves:
        if len(x) == 0:
            x = x.reshape((0,) + ref.shape[1:])
        if x.shape[1:] != ref.shape[1:]:
            raise ValueError(f"trailing shape {x.shape[1:]} on one rank, {ref.shape[1:]} "
                             "on another")
        out.append(x)
    return out


def allgather_pytrees(tree) -> List[object]:
    """Gather one tree (dicts, lists and tuples of numpy arrays) from every
    rank; returns the list of trees in rank order (``[tree]`` without a
    process group).

    The trees have the same structure and dtypes on every rank.  A leaf's
    leading axis may differ from rank to rank (ragged evaluation shards),
    and an empty shard may pass ``zeros((0,), dtype)``: its trailing shape is
    taken from the longest shard.  The trees travel pickled, by
    ``all_gather_object`` over gloo (``_gloo_group``)."""
    if world_size() == 1:
        return [tree]
    trees: list = [None] * world_size()
    dist.all_gather_object(trees, tree, group=_gloo_group())
    return _restore_empty(trees)


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if world_size() > 1:
        dist.barrier(group=_gloo_group())
