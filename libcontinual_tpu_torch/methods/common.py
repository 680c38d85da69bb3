"""Shared utilities for the method zoo (``libcontinual_tpu/methods/common.py``)."""

from __future__ import annotations

import torch


def normalized(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)
