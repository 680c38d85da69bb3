"""Shared utilities for the method zoo (``libcontinual_tpu/methods/common.py``)."""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def kd_loss(pred_logits: torch.Tensor, soft_logits: torch.Tensor, T: float = 2.0,
            class_mask: Optional[torch.Tensor] = None,
            weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hinton KD as the reference computes it: softmax over the (masked)
    class set, sum over classes, weighted mean over the batch, no T^2
    rescale."""
    if class_mask is not None:
        keep = class_mask[None, :] > 0
        pred_logits = torch.where(keep, pred_logits, -1e30)
        soft_logits = torch.where(keep, soft_logits, -1e30)
    p = F.log_softmax(pred_logits / T, dim=1)
    s = F.softmax(soft_logits / T, dim=1)
    if class_mask is not None:
        s = s * keep
    per = -torch.sum(s * p, dim=1)
    if weight is None:
        return per.mean()
    return torch.sum(per * weight) / torch.clamp(weight.sum(), min=1.0)


def snapshot(params: nn.ModuleDict) -> nn.ModuleDict:
    """A frozen copy of the modules, their running statistics included: a
    distillation teacher."""
    return copy.deepcopy(params).requires_grad_(False)


def select_mask(task: int, task0_mask: torch.Tensor, later_mask: torch.Tensor) -> torch.Tensor:
    """The class mask of task 0, or of every later task."""
    return later_mask if task > 0 else task0_mask


def masked_eval_logits(method, state, x) -> torch.Tensor:
    """The method's logits with the classes not seen yet at -1e30: a head
    grown per task could not pick them."""
    logits = method.forward(state.params, x, train=False)[0]
    return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)


def head_kernel(params) -> torch.Tensor:
    """The linear head's weight, ``(num_class, in)``: one row per class (the
    flax kernel's column)."""
    return params["head"].dense.weight


@torch.no_grad()
def set_head_kernel(params, weight: torch.Tensor) -> None:
    """Write the linear head's weight in place, so the optimizer keeps its
    ``Parameter``."""
    params["head"].dense.weight.copy_(weight)


def zeros_like_tree(tree) -> Dict[str, torch.Tensor]:
    """Zeros shaped like each named parameter of a module (or each tensor
    of a dict): the per-parameter accumulators of EWC's Fisher."""
    items = tree.named_parameters() if isinstance(tree, nn.Module) else tree.items()
    return {k: torch.zeros_like(v) for k, v in items}


def normalized(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def copy_tree(tree) -> Dict[str, Any]:
    """A detached copy of a dict (or module dict) of tensors, nested dicts
    included: a snapshot that later in-place updates do not reach."""
    return {k: copy_tree(v) if isinstance(v, (dict, nn.Module)) else v.detach().clone()
            for k, v in tree.items()}


def batch_iter(images: np.ndarray, labels: np.ndarray, batch_size: int,
               device) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Padded batches (uint8) for task-boundary passes, on ``device``; yields
    (images, labels, weight), the padding weighing 0."""
    n = len(labels)
    for lo in range(0, n, batch_size):
        chunk_im = images[lo: lo + batch_size]
        chunk_lb = labels[lo: lo + batch_size]
        pad = batch_size - len(chunk_lb)
        w = np.ones(batch_size, np.float32)
        if pad:
            chunk_im = np.concatenate([chunk_im, np.repeat(chunk_im[-1:], pad, 0)])
            chunk_lb = np.concatenate([chunk_lb, np.repeat(chunk_lb[-1:], pad, 0)])
            w[batch_size - pad:] = 0.0
        yield (torch.from_numpy(np.ascontiguousarray(chunk_im)).to(device),
               torch.from_numpy(chunk_lb.astype(np.int64)).to(device),
               torch.from_numpy(w).to(device))


def svd_driver(a: torch.Tensor):
    """The cuSOLVER driver of the task-boundary SVDs: ``gesvd`` on the card,
    none elsewhere. The default Jacobi driver does not converge on
    rank-deficient activation residuals and falls back after seconds (API's
    task-1 ``after_task`` on an H100: ``PERF.md``, PR 12)."""
    return "gesvd" if a.is_cuda else None


def svd(a: torch.Tensor, full_matrices: bool = True):
    """``torch.linalg.svd`` with :func:`svd_driver`."""
    return torch.linalg.svd(a, full_matrices=full_matrices, driver=svd_driver(a))


def svdvals(a: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.svdvals`` with :func:`svd_driver`."""
    return torch.linalg.svdvals(a, driver=svd_driver(a))


def energy(s: torch.Tensor) -> float:
    """The sum of the squared singular values, on the host."""
    return float(torch.sum(s ** 2))
