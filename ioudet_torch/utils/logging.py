"""Rank-aware root logger (counterpart of ``ioudet/utils/logging.py``).

Rank 0 logs at the requested level; every other rank of a
``torch.distributed`` group logs at ERROR only, so that N ranks do not print
each record N times.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..parallel.mesh import rank

FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(log_level: int = logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """The ``ioudet_torch`` logger: one stream handler, plus a file handler
    for each new ``log_file``; the level is set on every call, from this
    process's rank at that time."""
    logger = logging.getLogger("ioudet_torch")
    fmt = logging.Formatter(FORMAT)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file is not None and not any(
            getattr(h, "baseFilename", None) == os.path.abspath(log_file) for h in logger.handlers):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(log_level if rank() == 0 else logging.ERROR)
    logger.propagate = False
    return logger
