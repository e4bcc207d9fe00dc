"""Build, load and launch machinery shared by the CUDA kernels' wrappers.

Each source under ``ioudet_torch/csrc`` has a plain C interface.  A
``KernelLibrary`` compiles its source with nvcc at first use into
``ioudet_torch/_build/`` (under a hash of the source and the flags, so an
edited source or changed flags build anew), loads it with ctypes and sets the
argument types of its functions.  ``build_all`` starts one nvcc per library
at once.  ``launch`` calls a function on PyTorch's current stream, raises if
the launch was refused and adds one to the kernel's entry in ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

PTR, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)

# launches of every kernel by name, counted where a wrapper launches it
launches: Dict[str, int] = {}

# True: compile with ``-Xptxas -v`` and print what nvcc said (each kernel's
# registers, spills and shared memory) on stderr after a build
ptxas_verbose = False


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from source at first use")


class KernelLibrary:
    """One ``.cu`` source, its nvcc flags and the C functions it exports.

    ``functions`` maps a C function name to its argument types, the stream
    (always last) left out; every function returns the cudaError of its
    launch as an int.  ``kernels`` names the ``__global__`` kernels whose
    launches are counted.
    """

    def __init__(self, source: str, extra_flags: Sequence[str],
                 functions: Dict[str, list], kernels: Sequence[str]):
        self.source = CSRC / source
        self.extra_flags = tuple(extra_flags)
        self.functions = functions
        self._lib: Optional[ctypes.CDLL] = None
        for name in kernels:
            launches.setdefault(name, 0)

    @property
    def flags(self) -> tuple:
        return BASE_FLAGS + self.extra_flags + (("-Xptxas", "-v") if ptxas_verbose else ())

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes() +
                                " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def start_build(self) -> Optional[tuple]:
        """Start nvcc unless the library exists; returns (process, tmp, out)."""
        out = self.path()
        if self._lib is not None or out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp, out

    def finish_build(self, started: Optional[tuple]) -> None:
        if started is None:
            return
        proc, tmp, out = started
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{stderr}")
        if ptxas_verbose:
            print(f"nvcc on {self.source.name}:\n{stderr}", file=sys.stderr, flush=True)
        os.replace(tmp, out)

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.path()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes) + [PTR]
                fn.restype = I32
            self._lib = lib
        return self._lib


def build_all(libraries: Sequence[KernelLibrary]) -> None:
    """Compile the libraries side by side (one nvcc each), then load them."""
    started = [lib.start_build() for lib in libraries]
    for lib, s in zip(libraries, started):
        lib.finish_build(s)
        lib.build()


def launch(fn, kernel: str, *args) -> None:
    """Call the C function ``fn`` on PyTorch's current stream, without a
    sync; count the launch of ``kernel``."""
    err = fn(*args, PTR(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    launches[kernel] += 1


def check_tensor(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is an ``ndim``-d tensor of one of ``dtypes`` on the
    CPU or a CUDA device."""
    dtypes = dtypes if isinstance(dtypes, (tuple, list)) else (dtypes,)
    if t.dtype not in dtypes or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {' or '.join(map(str, dtypes))}, "
                         f"got {t.dim()}-d {t.dtype}")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {t.device}")
