"""Chained necks (counterpart of ``ioudet/models/necks/neck_sequence.py``):
a config's ``neck`` given as a list (Libra R-CNN's FPN -> BFP) builds an
``nn.Sequential`` of the necks, so that mmdet's checkpoints load under
their ``neck.0.*`` / ``neck.1.*`` names."""

from __future__ import annotations

import torch
from torch import nn


class NeckSequence(nn.Sequential):
    def init_weights(self, generator: torch.Generator) -> None:
        for neck in self:
            neck.init_weights(generator)
