"""int8 (w8a8) quantized inference for the conv stack (counterpart of
``ioudet/ops/quant.py``).

  * weights: symmetric absmax int8 per output channel, quantized from the f32
    parameters when ``quantize_calls`` is entered;
  * activations: symmetric int8 per tensor, with a dynamic absmax per call
    (``act_scale=None``; computed on the device, no host sync) or static
    scales: one scalar for every conv, or a dict per conv from ``calibrate``;
  * the convolution runs int8 x int8 -> int32, is dequantized with the
    combined scale ``sx * sw`` in f32, gets the f32 bias and is cast to the
    conv's compute dtype, in that order.

PyTorch has no int8 convolution on CUDA, so the product is built here: the
quantized input is laid out NHWC, its windows are gathered into a
(B*Ho*Wo, kh*kw*C) matrix (a strided view, copied once; a 1x1 stride-1 conv
needs no copy), the weight is taken as (O, kh*kw*I), and
``mma_cuda.tiled_matmul_dequant`` gives the dequantized product in the
compute dtype: on the card the hand-written ``wgmma`` kernel, whose epilogue
turns the exact int32 accumulators into ``cast(float(acc) * (sx * sw) + bias)``
before anything is written (no int32 tensor reaches device memory), on the
CPU its plain version, the same three steps as torch passes.

``quantize_calls(model, ...)`` is a context manager that swaps the ``forward``
of every eligible ``nn.Conv2d`` of ``model`` for the quantized call for the
length of the ``with`` block (flax's ``nn.intercept_methods`` has no torch
twin).  The module tree, its parameters and its ``state_dict`` are untouched.
A conv whose own name or whose parent's name contains an entry of ``skip``
runs unquantized: the output convs (cls / reg / iou logits) stay exact.

Trap: on the card ``tensor / python_float`` multiplies by a reciprocal, which
moves values at .5 boundaries; every scale here is a 0-d device tensor and
every division is tensor by tensor, so that the card agrees with the CPU and
with ``ioudet``.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import mma_cuda

DEFAULT_SKIP = ("retina_cls", "retina_reg", "retina_iou", "conv_logits",
                "rpn_cls", "rpn_reg")
K_ALIGN = 16   # bytes: TMA wants the gathered matrix's row pitch a multiple of 16


def _const(value: float, device) -> torch.Tensor:
    """A 0-d f32 tensor made on the device (a fill, not a host copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _quantize_tensor(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric absmax -> (int8 values, 0-d f32 scale).  A fixed
    ``scale`` (0-d tensor on x's device) skips the absmax reduce."""
    xf = x.float()
    if scale is None:
        scale = xf.abs().amax().clamp(min=1e-8) / _const(127.0, x.device)
    q = (xf / scale).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel absmax over an OIHW kernel -> (int8, (O,) scales)."""
    w = w.float()
    s = w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-8) / _const(127.0, w.device)
    q = (w / s[:, None, None, None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), s


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _padding(mod: nn.Conv2d) -> Tuple[int, int]:
    """(rows, columns) of the conv's own zero padding, on each side."""
    if mod.padding_mode != "zeros" or isinstance(mod.padding, str):
        raise NotImplementedError(f"padding {mod.padding!r} ({mod.padding_mode}) is not "
                                  "quantized: give the conv explicit zero padding")
    return _pair(mod.padding)


def weight_matrix(mod: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conv's quantized weight as the product's second operand: (O, K)
    int8 with K = kh*kw*I/groups in window order, zero-padded to a multiple
    of ``K_ALIGN``, and its (O,) scales.  The rows of group i are the
    i-th O/groups of them."""
    wq, sw = _quantize_weight(mod.weight.detach())
    mat = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
    return F.pad(mat, (0, -mat.shape[1] % K_ALIGN)).contiguous(), sw


def gather_windows(q: torch.Tensor, kernel_size, stride, dilation) -> Tuple[torch.Tensor, int, int]:
    """q (B, H, W, C) int8, already padded -> ((B*Ho*Wo, Kp) int8, Ho, Wo): row
    (b, i, j) holds the conv window at output pixel (i, j) in (kh, kw, C)
    order, zero-padded from K = kh*kw*C to a multiple of ``K_ALIGN``."""
    bsz, h, w, c = q.shape
    (kh, kw), (sh, sw), (dh, dw) = _pair(kernel_size), _pair(stride), _pair(dilation)
    ho = (h - dh * (kh - 1) - 1) // sh + 1
    wo = (w - dw * (kw - 1) - 1) // sw + 1
    k = kh * kw * c
    kp = k + -k % K_ALIGN
    if (kh, kw, sh, sw) == (1, 1, 1, 1) and kp == k:
        return q.reshape(bsz * h * w, c), ho, wo
    sb, s_h, s_w, sc = q.stride()
    windows = q.as_strided((bsz, ho, wo, kh, kw, c),
                           (sb, s_h * sh, s_w * sw, s_h * dh, s_w * dw, sc))
    cols = torch.empty(bsz * ho * wo, kp, dtype=q.dtype, device=q.device)
    cols.as_strided((bsz, ho, wo, kh, kw, c),
                    (ho * wo * kp, wo * kp, kp, kw * c, c, 1)).copy_(windows)
    if kp != k:
        cols[:, k:] = 0
    return cols, ho, wo


def quant_conv_call(mod: nn.Conv2d, x: torch.Tensor,
                    act_scale: Optional[torch.Tensor] = None,
                    weight: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Quantized twin of ``mod(x)`` on the module's own parameters: x (B, C,
    H, W) -> (B, O, Ho, Wo) in the conv's compute dtype.  ``act_scale``: a 0-d
    f32 tensor on x's device, or None for the dynamic absmax.  ``weight``:
    what ``weight_matrix(mod)`` gave, if it was made ahead.  A grouped conv
    runs one window gather and one product a group, on the group's channels
    and rows, and concatenates the groups' outputs by channel."""
    wmat, sw = weight if weight is not None else weight_matrix(mod)
    q, sx = _quantize_tensor(x, act_scale)
    ph, pw = _padding(mod)
    q = q.permute(0, 2, 3, 1)
    q = (F.pad(q, (0, 0, pw, pw, ph, ph)) if ph or pw else q).contiguous()
    scale = sx * sw
    bias = None if mod.bias is None else mod.bias.detach().float()
    dtype = getattr(mod, "compute_dtype", torch.float32)
    cin, cout = q.shape[3] // mod.groups, wmat.shape[0] // mod.groups
    outs = []
    for i in range(mod.groups):
        cols, ho, wo = gather_windows(q[..., i * cin:(i + 1) * cin], mod.kernel_size,
                                      mod.stride, mod.dilation)
        rows = slice(i * cout, (i + 1) * cout)
        outs.append(mma_cuda.tiled_matmul_dequant(cols, wmat[rows], scale[rows],
                                                  None if bias is None else bias[rows], dtype))
        del cols
    y = outs[0] if mod.groups == 1 else torch.cat(outs, dim=1)
    return y.view(x.shape[0], ho, wo, -1).permute(0, 3, 1, 2)


def _names(path: str) -> Tuple[str, str]:
    """(own name, parent's name) of a module path, an index of a ModuleList
    or Sequential joined to the name before it: 'bbox_head.cls_convs.0.conv'
    -> ('conv', 'cls_convs.0')."""
    parts = re.findall(r"[^.]+(?:\.\d+)*", path) or [""]
    return parts[-1], parts[-2] if len(parts) > 1 else ""


def eligible_convs(model: nn.Module, skip: Sequence[str] = DEFAULT_SKIP
                   ) -> Iterator[Tuple[str, nn.Conv2d]]:
    """(path, module) of every ``nn.Conv2d`` of ``model`` that
    ``quantize_calls`` reroutes: all but those whose own or parent's name
    contains an entry of ``skip``.  A model holding a module whose class
    sets ``INT8 = False`` (the anchor-free heads) raises
    ``NotImplementedError``: its int8 serving is not ported."""
    for mod in model.modules():
        if getattr(type(mod), "INT8", True) is False:
            raise NotImplementedError(f"int8 serving of {type(mod).__name__} is not ported yet")
    for path, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            own, parent = _names(path)
            if not any(s in own or s in parent for s in skip):
                yield path, mod


@contextlib.contextmanager
def _swapped_forwards(forwards: Dict[nn.Module, Callable]):
    """Give each module the forward mapped to it for the length of the block;
    the class's own forward is back afterwards, also after an exception."""
    kept = {mod: mod.__dict__.get("forward") for mod in forwards}
    try:
        for mod, fn in forwards.items():
            mod.forward = fn
        yield
    finally:
        for mod, old in kept.items():
            if old is None:
                mod.__dict__.pop("forward", None)
            else:
                mod.forward = old


@contextlib.contextmanager
def quantize_calls(model: nn.Module, skip: Sequence[str] = DEFAULT_SKIP,
                   act_scale: Union[None, float, Dict[str, float]] = None):
    """Inside the block every eligible conv of ``model`` runs int8 (w8a8):
    dynamic absmax by default, static with ``act_scale``, a scalar or a dict
    keyed by module path from ``calibrate`` (a conv the dict does not name
    runs dynamic).  Weights are quantized once, on entry, on the device they
    are on; static scales become 0-d device tensors there too, so that a call
    inside the block copies nothing from the host.  Example::

        scales = calibrate(handle.model, lambda b: predict(handle, *b), [batch])
        with quantize_calls(handle.model, act_scale=scales):
            dets, labels = predict(handle, imgs, img_shapes, factors, pads)
    """
    forwards = {}
    for path, mod in eligible_convs(model, skip):
        scale = act_scale.get(path) if isinstance(act_scale, dict) else act_scale
        if scale is not None:
            scale = torch.tensor(float(scale), dtype=torch.float32).to(mod.weight.device)
        forwards[mod] = lambda x, m=mod, s=scale, w=weight_matrix(mod): \
            quant_conv_call(m, x, s, w)
    with _swapped_forwards(forwards):
        yield


def calibrate(model: nn.Module, run: Callable[[object], object], batches: Iterable,
              skip: Sequence[str] = DEFAULT_SKIP, margin: float = 1.0) -> Dict[str, float]:
    """Per-conv static activation scales for w8a8 inference.

    Calls ``run(batch)`` (anything that drives ``model``, unquantized) for
    each of ``batches`` and returns ``{module path: absmax over the batches *
    margin / 127}`` for every eligible conv it reached, for
    ``quantize_calls(act_scale=...)``.  An offline pass: it reads one number
    per conv call back to the host.

    As in ``ioudet``, a conv that one batch calls several times (the head's
    towers, shared by the FPN levels) records its last call of that batch, not
    the largest: the two packages give the same dict for the same weights and
    batches."""
    convs = dict(eligible_convs(model, skip))
    seen: Dict[str, float] = {}

    def recording(path: str, mod: nn.Conv2d) -> Callable:
        def forward(x):
            seen[path] = float(x.detach().float().abs().amax())
            return type(mod).forward(mod, x)
        return forward

    maxima: Dict[str, float] = {}
    with _swapped_forwards({mod: recording(path, mod) for path, mod in convs.items()}):
        for batch in batches:
            seen.clear()
            run(batch)
            for path, v in seen.items():
                maxima[path] = max(maxima.get(path, 0.0), v)
    return {k: max(v * margin, 1e-8) / 127.0 for k, v in maxima.items()}
