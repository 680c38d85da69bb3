"""LwF, Learning without Forgetting (Li & Hoiem, 2016)
(``libcontinual_tpu/methods/lwf.py``).

  * task 0: CE over the seen classes; later tasks: CE over the current
    task's classes plus ``lamda`` (3) times the T = 2 KD of the old classes'
    logits against the network frozen before the task (the teacher, in
    train mode on the batch's statistics unless ``teacher_batch_stats:
    false``; its running statistics never move);
  * no replay: the CE of an old class would meet its masked logit;
  * evaluation masks the classes not seen yet.
"""

from __future__ import annotations

import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import (kd_loss, masked_eval_logits, select_mask,
                                                   snapshot)
from libcontinual_tpu_torch.registry import METHODS


@METHODS.register("LWF")
class LWF(Method):
    concat_buffer = False

    def __init__(self, config, device):
        super().__init__(config, device)
        self.lamda = float(self.kwargs.get("lamda", 3.0))
        self.T = float(self.kwargs.get("T", 2.0))

    def init_mvars(self, state):
        return {"teacher": snapshot(state.params)}

    def before_task(self, state, task_idx, task_data):
        if task_idx > 0:
            state.mvars["teacher"] = snapshot(state.params)
        return state

    def loss(self, state, batch):
        logits, _ = self.forward(state.params, batch["x"], train=True)
        mask = select_mask(state.task, state.seen_mask, state.seen_mask - state.prev_mask)
        w = batch.get("weight")
        ce = masked_cross_entropy(logits, batch["label"], w, mask)
        if state.task == 0:
            return ce, {"logits": logits}
        with torch.no_grad():
            t_logits, _ = self.forward(state.mvars["teacher"], batch["x"],
                                       train=self.teacher_train, update_stats=False)
        kd = kd_loss(logits, t_logits, T=self.T, class_mask=state.prev_mask, weight=w)
        return ce + self.lamda * kd, {"logits": logits}

    def eval_logits(self, state, x, task_id):
        return masked_eval_logits(self, state, x)
