"""WA, Weight Aligning (Zhao et al., CVPR 2020)
(``libcontinual_tpu/methods/wa.py``).

  * loss ``(1 - lam) * CE + lam * KD`` with ``lam = known / seen`` (0 at
    task 0): CE over the seen classes, T = 2 KD of the old classes' logits
    against the network frozen after the previous task (in train mode on the
    batch's statistics unless ``teacher_batch_stats: false``);
  * after each task t > 0, the head's rows of the new classes are scaled by
    ``gamma = mean |w_old| / mean |w_new|`` (row norms: the port's head
    weight is ``(num_class, in)``), then the teacher is taken;
  * the trainer's herding buffer replays; evaluation masks the classes not
    seen yet.
"""

from __future__ import annotations

import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import (head_kernel, kd_loss, masked_eval_logits,
                                                   set_head_kernel, snapshot)
from libcontinual_tpu_torch.registry import METHODS


@torch.no_grad()
def align_weights(weight: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``weight`` (num_class, in) with rows [lo, hi) scaled so their mean
    norm equals the mean norm of rows [0, lo)."""
    norms = torch.linalg.vector_norm(weight, dim=1)
    gamma = norms[:lo].mean() / torch.clamp(norms[lo:hi].mean(), min=1e-12)
    rows = torch.arange(weight.shape[0], device=weight.device)
    new = ((rows >= lo) & (rows < hi))[:, None]
    return torch.where(new, weight * gamma, weight)


@METHODS.register("WA")
class WA(Method):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.T = float(self.kwargs.get("T", 2.0))

    def init_mvars(self, state):
        return {"teacher": snapshot(state.params)}

    def loss(self, state, batch):
        logits, _ = self.forward(state.params, batch["x"], train=True)
        w = batch.get("weight")
        ce = masked_cross_entropy(logits, batch["label"], w, state.seen_mask)
        # the metric's argmax skips the columns no task has trained yet
        masked = torch.where(state.seen_mask[None, :] > 0, logits, -1e30)
        if state.task == 0:
            return ce, {"logits": masked}
        with torch.no_grad():
            t_logits, _ = self.forward(state.mvars["teacher"], batch["x"],
                                       train=self.teacher_train, update_stats=False)
        kd = kd_loss(logits, t_logits, T=self.T, class_mask=state.prev_mask, weight=w)
        lam = state.prev_mask.sum() / torch.clamp(state.seen_mask.sum(), min=1.0)
        return (1.0 - lam) * ce + lam * kd, {"logits": masked}

    def after_task(self, state, task_idx, task_data):
        if task_idx > 0:
            set_head_kernel(state.params, align_weights(head_kernel(state.params),
                                                        *self.class_range(task_idx)))
        state.mvars["teacher"] = snapshot(state.params)
        return state

    def eval_logits(self, state, x, task_id):
        return masked_eval_logits(self, state, x)
