"""Classifier heads (``libcontinual_tpu/models/heads.py``): the linear head,
LUCIR's cosine head and BiC's bias correction. Heads are allocated at full
``num_class`` width and masked per task."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class LinearHead(nn.Module):
    """f32 linear head; flax ``kaiming_uniform`` kernel (U(+-sqrt(6/fan_in)))
    and zero bias (none with ``use_bias=False``: GPM, TRGP, API)."""

    def __init__(self, in_features: int, num_class: int,
                 generator: Optional[torch.Generator] = None, use_bias: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, num_class, bias=use_bias)
        self.reset_parameters(generator)

    def reset_parameters(self, gen=None) -> None:
        limit = math.sqrt(6.0 / self.dense.in_features)
        with torch.no_grad():
            self.dense.weight.uniform_(-limit, limit, generator=gen)
            if self.dense.bias is not None:
                self.dense.bias.zero_()

    def forward(self, feats):
        bias = self.dense.bias
        return F.linear(feats.float(), self.dense.weight.float(),
                        None if bias is None else bias.float())


class CosineLinear(nn.Module):
    """LUCIR's cosine classifier: the cosine between the features and each
    class's weight row, times a learnable scalar ``sigma`` (1 at init). The
    weight is ``(num_class, in)`` and drawn from flax ``kaiming_uniform``;
    both norms add ``eps`` (1e-12), as the JAX head does."""

    def __init__(self, in_features: int, num_class: int,
                 generator: Optional[torch.Generator] = None, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_class, in_features))
        self.sigma = nn.Parameter(torch.ones(()))
        limit = math.sqrt(6.0 / in_features)
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)

    def scores(self, feats):
        """The cosines before ``sigma``: ``(B, num_class)`` f32."""
        f = feats.float()
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + self.eps)
        w = self.weight / (torch.linalg.vector_norm(self.weight, dim=1, keepdim=True) + self.eps)
        return f @ w.T

    def forward(self, feats):
        return self.scores(feats) * self.sigma


class DistLinear(nn.Module):
    """ER-ACE / ER-AML's cosine head at a fixed scale (10): the cosine
    between the features and each class's weight row, both norms with
    ``+1e-5``. The weight is ``(num_class, in)``, one row per class (the flax
    kernel's column), drawn from flax ``kaiming_uniform`` (U(+-sqrt(6/in)),
    ``nn.init.kaiming_uniform_`` with ``a=0``)."""

    def __init__(self, in_features: int, num_class: int,
                 generator: Optional[torch.Generator] = None, scale: float = 10.0):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.empty(num_class, in_features))
        nn.init.kaiming_uniform_(self.weight, a=0.0, generator=generator)

    def forward(self, feats):
        f = feats.float()
        f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-5)
        w = self.weight / (torch.linalg.vector_norm(self.weight, dim=1, keepdim=True) + 1e-5)
        return self.scale * (f @ w.T)


def bias_correct(logits: torch.Tensor, alphas: torch.Tensor, betas: torch.Tensor,
                 task_of_class: torch.Tensor) -> torch.Tensor:
    """BiC's per-task bias layers: ``alpha_t * logit + beta_t`` for each class
    of task t (``task_of_class`` maps a class to its task)."""
    return logits * alphas[task_of_class] + betas[task_of_class]
