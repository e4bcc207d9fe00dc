"""Start the ranks of a data-parallel run from one command: the
``--n-devices N`` route of ``tools/train.py`` and ``tools/test.py``, where
no launcher (``torchrun``) started the processes.  Each rank is a spawned
process that runs the tool's ``main`` with ``RANK`` / ``LOCAL_RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set, as ``torchrun``
sets them; a rank that fails ends the others and raises here."""

from __future__ import annotations

import importlib
import os
import socket
from typing import List

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_devices(n: int, device: str) -> None:
    """N ranks on cards need N cards (one process a card)."""
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if n > torch.cuda.device_count():
        raise ValueError(f"--n-devices {n}, but this host has {torch.cuda.device_count()} "
                         "CUDA device(s)")


def _rank(index: int, module: str, argv: List[str], n: int, port: int) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        importlib.import_module(module).main(argv)
    finally:
        # leave the group before the interpreter exits: a gloo group torn
        # down at exit, while a peer is still connected, can abort the rank
        # ("terminate called without an active exception", SIGABRT)
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(module: str, argv: List[str], n: int) -> None:
    """``module.main(argv)`` in ``n`` spawned ranks on this host; returns
    when all have ended, and raises if one failed."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(module, list(argv), n, free_port()), nprocs=n,
                       join=True, start_method="spawn")


def needs_spawn(n_devices) -> bool:
    """True where ``--n-devices`` asks for more than one rank and no
    launcher has started them."""
    return bool(n_devices) and n_devices > 1 and "WORLD_SIZE" not in os.environ
