"""Continual-learning metric suite (``libcontinual_tpu/core/metrics.py``).

The formulas are the comparability contract with the reference and are
reproduced exactly (reference core/utils/utils.py:202-232, README.md:88-116):

  * ``acc_table[i, j]``: accuracy on task ``j``'s test set after training
    task ``i`` (row i filled after task i; upper triangle unused).
  * Backward transfer (positive BwT of Continuum, arXiv:1810.13166).
  * Forgetting (Continuum's definition).
"""

from __future__ import annotations

import numpy as np


def compute_bwt(acc_table: np.ndarray, curr_acc: np.ndarray, task_idx: int) -> float:
    """Backward transfer after training ``task_idx + 1`` tasks.

    Mirrors reference core/utils/utils.py:202-221 including its indexing:
    ``curr_acc`` holds the just-measured accuracies of tasks ``0..task_idx``.
    """
    if task_idx > 1:
        bwt = 0.0
        for i in range(2, task_idx):
            for j in range(i - 1):
                bwt += acc_table[i, j] - acc_table[j, j]
        for j in range(task_idx - 1):
            bwt += curr_acc[j] - acc_table[j, j]
        return (bwt * 2) / (task_idx * (task_idx + 1))
    return 0.0


def compute_frgt(acc_table: np.ndarray, curr_acc: np.ndarray, task_idx: int) -> float:
    """Forgetting after training ``task_idx + 1`` tasks.

    Mirrors reference core/utils/utils.py:224-232.
    """
    if task_idx > 1:
        diag = np.diag(acc_table)[: task_idx - 1]
        return float(np.sum(diag - curr_acc[: task_idx + 1][:-2]) / task_idx)
    return 0.0


def count_parameters(params) -> int:
    """Number of scalar parameters of a module that train."""
    return int(sum(p.numel() for p in params.parameters() if p.requires_grad))
