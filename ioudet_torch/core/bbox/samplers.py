"""Samplers (counterpart of ``ioudet/core/bbox/samplers.py``).

A "sample" is a pair of boolean masks over the candidates of each image,
with the leading dimensions of the ``AssignResult`` (one image or a batch):
no index gathers, fixed shapes.  Every sampler turns per-candidate
priorities into masks by rank (``_cap_by_rank``): positives capped at
``num * pos_fraction``, negatives fill the rest of ``num``.

The draws and the rule are apart: ``sample(assign, generator)`` draws the
uniform noise from the caller's ``torch.Generator`` (positives first, then
negatives), and ``select(assign, pos_noise, neg_noise)`` is a function of
the noise alone, so a test can feed it ``ioudet``'s draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .assigners import AssignResult


class SampleMasks(NamedTuple):
    pos_mask: torch.Tensor  # (..., N) bool
    neg_mask: torch.Tensor  # (..., N) bool


class PseudoSampler:
    """Every positive and every negative takes part (no subsampling)."""

    def sample(self, assign_result: AssignResult, *_, **__) -> SampleMasks:
        return SampleMasks(assign_result.gt_inds > 0, assign_result.gt_inds == 0)


def _cap_by_rank(mask: torch.Tensor, limit, priority: torch.Tensor) -> torch.Tensor:
    """At most ``limit`` (an int or a tensor of the leading shape) True
    entries of ``mask`` along the last axis, highest ``priority`` first; ties
    to the lower index (``jnp.argsort``'s stable order)."""
    score = torch.where(mask, priority, -torch.inf)
    rank = torch.argsort(torch.argsort(-score, dim=-1, stable=True), dim=-1, stable=True)
    if isinstance(limit, torch.Tensor):
        limit = limit[..., None]
    return mask & (rank < limit)


def uniform(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) noise of ``shape`` from ``generator`` (which lives on
    ``device``)."""
    return torch.rand(shape, generator=generator, device=device)


class RandomSampler:
    """Positives capped at ``num * pos_fraction`` and negatives filling the
    rest of ``num`` (at most ``neg_pos_ub`` times the positives where
    ``neg_pos_ub >= 0``), each chosen uniformly."""

    def __init__(self, num: int, pos_fraction: float, neg_pos_ub: int = -1,
                 add_gt_as_proposals: bool = False):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub
        self.add_gt_as_proposals = add_gt_as_proposals

    def _pos_priority(self, assign_result: AssignResult, noise: torch.Tensor):
        return noise

    def _neg_priority(self, assign_result: AssignResult, noise: torch.Tensor):
        return noise

    def select(self, assign_result: AssignResult, pos_noise: torch.Tensor,
               neg_noise: torch.Tensor) -> SampleMasks:
        pos = assign_result.gt_inds > 0
        neg = assign_result.gt_inds == 0
        pos_s = _cap_by_rank(pos, int(self.num * self.pos_fraction),
                             self._pos_priority(assign_result, pos_noise))
        n_pos = pos_s.sum(dim=-1)
        n_neg = self.num - n_pos
        if self.neg_pos_ub >= 0:
            n_neg = torch.minimum(n_neg, self.neg_pos_ub * n_pos.clamp(min=1))
        neg_s = _cap_by_rank(neg, n_neg, self._neg_priority(assign_result, neg_noise))
        return SampleMasks(pos_s, neg_s)

    def sample(self, assign_result: AssignResult,
               generator: Optional[torch.Generator] = None) -> SampleMasks:
        shape, dev = assign_result.gt_inds.shape, assign_result.gt_inds.device
        pos_noise = uniform(shape, generator, dev)
        return self.select(assign_result, pos_noise, uniform(shape, generator, dev))


def _round_robin(group: torch.Tensor, noise: torch.Tensor,
                 among: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Priority that takes each group's lowest-noise member before any
    group's second: minus the count of same-group members (of ``among``)
    with smaller noise, plus the noise / 1000 inside a rank."""
    same = (group[..., :, None] == group[..., None, :]) & \
        (noise[..., None, :] < noise[..., :, None])
    if among is not None:
        same = same & among[..., None, :]
    return -same.sum(dim=-1).float() + noise * 1e-3


class InstanceBalancedPosSampler(RandomSampler):
    """Positives spread over the gt instances, round-robin by each
    instance's noise rank."""

    def _pos_priority(self, assign_result, noise):
        return _round_robin(assign_result.gt_inds, noise)


class IoUBalancedNegSampler(RandomSampler):
    """Negatives spread over ``num_bins`` IoU bins, round-robin by each
    bin's noise rank among the negatives (Libra R-CNN)."""

    def __init__(self, num: int, pos_fraction: float, floor_thr: float = -1,
                 floor_fraction: float = 0, num_bins: int = 3, **kw):
        super().__init__(num, pos_fraction, **kw)
        self.num_bins = num_bins
        self.floor_thr = floor_thr

    def _neg_priority(self, assign_result, noise):
        iou = assign_result.max_overlaps.clamp(0.0, 0.999)
        bins = (iou * self.num_bins).int()
        return _round_robin(bins, noise, among=assign_result.gt_inds == 0)


class OHEMSampler(RandomSampler):
    """The hardest candidates by the caller's per-candidate loss:
    ``sample_with_losses`` ranks by it where the random sampler ranks by
    noise, and leaves ``neg_pos_ub`` out, as ``ioudet`` does."""

    def sample_with_losses(self, assign_result: AssignResult,
                           losses: torch.Tensor) -> SampleMasks:
        pos = assign_result.gt_inds > 0
        neg = assign_result.gt_inds == 0
        pos_s = _cap_by_rank(pos, int(self.num * self.pos_fraction), losses)
        neg_s = _cap_by_rank(neg, self.num - pos_s.sum(dim=-1), losses)
        return SampleMasks(pos_s, neg_s)


class CombinedSampler:
    """Positives from one sampler, negatives from another."""

    def __init__(self, pos_sampler, neg_sampler):
        self.pos_sampler = pos_sampler
        self.neg_sampler = neg_sampler

    def sample(self, assign_result: AssignResult,
               generator: Optional[torch.Generator] = None) -> SampleMasks:
        pos = self.pos_sampler.sample(assign_result, generator).pos_mask
        neg = self.neg_sampler.sample(assign_result, generator).neg_mask
        return SampleMasks(pos, neg)


SAMPLERS = {
    "PseudoSampler": PseudoSampler,
    "RandomSampler": RandomSampler,
    "InstanceBalancedPosSampler": InstanceBalancedPosSampler,
    "IoUBalancedNegSampler": IoUBalancedNegSampler,
    "OHEMSampler": OHEMSampler,
}


def build_sampler(cfg: dict):
    """A sampler from a ``type=`` config dict (RandomSampler by default)."""
    cfg = dict(cfg)
    typ = cfg.pop("type", "RandomSampler")
    if typ == "CombinedSampler":
        return CombinedSampler(build_sampler(cfg.pop("pos_sampler")),
                               build_sampler(cfg.pop("neg_sampler")))
    if typ not in SAMPLERS:
        raise KeyError(f"sampler {typ!r} is not ported; available: "
                       f"{sorted(SAMPLERS) + ['CombinedSampler']}")
    return SAMPLERS[typ](**cfg)
