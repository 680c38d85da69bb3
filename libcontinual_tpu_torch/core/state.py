"""The training state (``libcontinual_tpu/core/state.py``).

The trainable modules, the optimizer, the method-owned variables (the frozen
backbone among them), the generator for augmentation draws, and the task
scalars and class masks, in one object that the trainer hands to the method.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    params: nn.ModuleDict  # trainable modules
    opt_state: torch.optim.Optimizer
    mvars: Dict[str, Any]  # method-owned, e.g. the "frozen" backbone
    rng: torch.Generator  # augmentation draws, on the device
    step: int  # global step
    task: int  # current task index
    seen_mask: torch.Tensor  # (num_class,) f32: classes seen incl. current task
    prev_mask: torch.Tensor  # (num_class,) f32: classes seen before current task


def make_masks(num_class: int, class_lo: int, class_hi: int, device=None):
    """seen/prev masks when training the task covering [class_lo, class_hi)."""
    idx = torch.arange(num_class, device=device)
    return (idx < class_hi).float(), (idx < class_lo).float()
