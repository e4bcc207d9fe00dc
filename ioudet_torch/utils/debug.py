"""Numerical health checks (counterpart of ``ioudet/utils/debug.py``): the
NaN / Inf guard over a model's parameters, its gradients or any dict of
tensors, and the parameter dtype policy of training in bf16."""

from __future__ import annotations

from typing import Dict

import torch


def check_finite(tree: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """The names of the floating tensors that hold a NaN or an Inf (a
    state_dict, ``grads_of(model)``, a loss dict); ``{}`` when all are
    finite.  One device reduction a tensor and one host copy for the lot."""
    names = [n for n, t in tree.items() if t is not None and torch.is_floating_point(t)]
    if not names:
        return {}
    ok = torch.stack([torch.isfinite(tree[n]).all() for n in names]).cpu().tolist()
    return {n: False for n, good in zip(names, ok) if not good}


def grads_of(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """name -> gradient of every parameter that has one."""
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def assert_dtype_policy(model: torch.nn.Module) -> None:
    """Training keeps every parameter in f32 (a low compute dtype casts per
    call); raises with the offenders."""
    bad = [(n, str(p.dtype)) for n, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"parameters not in float32: {bad}")
