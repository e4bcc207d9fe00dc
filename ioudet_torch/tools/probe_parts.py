"""What the parts probes of the kernels (``probe_assign_parts``,
``probe_focal_parts``, ``probe_wgmma_parts``) share: copies of a kernel
library's source with some lines replaced, built side by side, and a timer of
device time by CUDA events."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import _build

HOLD_CYCLES = 5_000_000   # ~2.5 ms at 2 GHz


def build_cut_variants(library: _build.KernelLibrary,
                       cuts: Dict[str, Sequence[Tuple[str, str]]],
                       baselines: Sequence[str] = (), prefix: str = "probe",
                       functions: Optional[Callable[[str], dict]] = None) -> dict:
    """name -> KernelLibrary, compiled side by side: ``whole`` (the library's
    source), the source with each entry of ``cuts`` made (name -> its
    (line, replacement) pairs; each line must be in the source exactly once),
    and each of ``baselines`` (other versions of the source) as it is, under
    its file stem.  The copies are written into the build directory as
    ``{prefix}_{name}.cu``; ``functions(text)`` gives the C interface of a
    copy (default: the library's)."""
    source = library.source.read_text()
    texts = {"whole": source}
    for name, pairs in cuts.items():
        text = source
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to replace is not in the source once:\n{old}")
            text = text.replace(old, new)
        texts[name] = text
    for path in baselines:
        texts[Path(path).stem] = Path(path).read_text()
    libs = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        path = _build.BUILD_DIR / f"{prefix}_{name}.cu"
        path.write_text(text)
        libs[name] = _build.KernelLibrary(
            str(path), library.extra_flags,
            functions(text) if functions is not None else library.functions, kernels=())
    _build.build_all(list(libs.values()))
    return libs


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` calls; the card spins first, so
    that the host has queued the calls before the first one starts."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
