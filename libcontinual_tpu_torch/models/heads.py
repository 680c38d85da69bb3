"""Classifier heads (``libcontinual_tpu/models/heads.py``). Heads are
allocated at full ``num_class`` width and masked per task."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class LinearHead(nn.Module):
    """f32 linear head; flax ``kaiming_uniform`` kernel (U(+-sqrt(6/fan_in)))
    and zero bias."""

    def __init__(self, in_features: int, num_class: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = nn.Linear(in_features, num_class)
        self.reset_parameters(generator)

    def reset_parameters(self, gen=None) -> None:
        limit = math.sqrt(6.0 / self.dense.in_features)
        with torch.no_grad():
            self.dense.weight.uniform_(-limit, limit, generator=gen)
            self.dense.bias.zero_()

    def forward(self, feats):
        return F.linear(feats.float(), self.dense.weight.float(), self.dense.bias.float())
