"""Environment helpers (counterpart of ``ioudet/apis/env.py``): the process
group (``init_dist``, from ``parallel``), seeding and an environment report
for the logs."""

from __future__ import annotations

import os
import random
import shutil
import subprocess

import numpy as np
import torch

from ..parallel.mesh import init_dist, world_size  # noqa: F401  (init_dist re-exported)


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's and numpy's generators and return a ``torch.Generator``
    seeded with ``seed`` for the caller to pass on.  Torch's global seed is
    left alone: weights are drawn from explicit generators, and a global
    seed set here would hide a draw that forgot its generator."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    return torch.Generator().manual_seed(seed)


def _nvcc_version() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        return "not found"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=False)
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else "not found"


def collect_env() -> dict:
    """torch, CUDA and cuDNN versions, nvcc's, the devices and the world
    size."""
    cuda = torch.cuda.is_available()
    return dict(
        torch=torch.__version__,
        cuda=torch.version.cuda,
        cudnn=torch.backends.cudnn.version() if cuda else None,
        nvcc=_nvcc_version(),
        device_count=torch.cuda.device_count() if cuda else 0,
        devices=[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else ["cpu"],
        world_size=world_size(),
    )
