"""EWC, Elastic Weight Consolidation (Kirkpatrick et al., 2016)
(``libcontinual_tpu/methods/ewc.py``).

  * task 0: CE over the seen classes; later tasks: CE over the current
    task's classes plus ``lamda`` times :func:`ewc_penalty` against the
    parameters after the previous task;
  * after each task, the diagonal Fisher over the task's data
    (:meth:`EWC.fisher`): in train mode, so the BatchNorm layers normalise
    with the batch's statistics and their running statistics move (what
    evaluation then sees), on train-transformed batches; ``g^2`` times the
    batch's weight sum, over ``batch_size * steps`` (padded batches count
    whole);
  * the merge with ``alpha = 1 - inc / seen``, which grows per task; the
    head's rows of the classes new in the task keep their new Fisher;
  * no replay; evaluation masks the classes not seen yet.

The Fisher and the reference parameters are dicts keyed by parameter name;
the running statistics are buffers, outside both.
"""

from __future__ import annotations

from typing import Dict

import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import (batch_iter, masked_eval_logits, select_mask,
                                                   zeros_like_tree)
from libcontinual_tpu_torch.registry import METHODS


def ewc_penalty(fisher: Dict[str, torch.Tensor], params, ref: Dict[str, torch.Tensor]):
    """``1/2 * sum F (p - p*)^2`` over the named parameters (the caller
    applies ``lamda``)."""
    total = sum(torch.sum(fisher[n] * (p - ref[n]) ** 2) for n, p in params.named_parameters())
    return total / 2.0


def _detached(params) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in params.named_parameters()}


@METHODS.register("EWC")
class EWC(Method):
    concat_buffer = False

    def __init__(self, config, device):
        super().__init__(config, device)
        self.lamda = float(self.kwargs.get("lamda", 1000.0))

    def init_mvars(self, state):
        return {"fisher": zeros_like_tree(state.params), "ref_params": _detached(state.params)}

    def loss(self, state, batch):
        logits, _ = self.forward(state.params, batch["x"], train=True)
        mask = select_mask(state.task, state.seen_mask, state.seen_mask - state.prev_mask)
        ce = masked_cross_entropy(logits, batch["label"], batch.get("weight"), mask)
        if state.task == 0:
            return ce, {"logits": logits}
        penalty = ewc_penalty(state.mvars["fisher"], state.params, state.mvars["ref_params"])
        return ce + self.lamda * penalty, {"logits": logits}

    def eval_logits(self, state, x, task_id):
        return masked_eval_logits(self, state, x)

    def fisher(self, state, task_data) -> Dict[str, torch.Tensor]:
        """The task's diagonal Fisher, normalised; the train-mode passes
        move the running statistics."""
        fisher = zeros_like_tree(state.params)
        names = list(fisher)
        params = [p for _, p in state.params.named_parameters()]
        bs = int(self.config["batch_size"])
        steps = 0
        for im, lb, w in batch_iter(task_data.images, task_data.labels, bs, self.device):
            x = self.augment(state.rng, im, train=True)
            logits, _ = self.forward(state.params, x, train=True)
            ce = masked_cross_entropy(logits, lb, w, state.seen_mask)
            grads = torch.autograd.grad(ce, params, allow_unused=True)
            n = w.sum()
            for name, g in zip(names, grads):
                if g is not None:
                    fisher[name] += g.detach() ** 2 * n
            steps += 1
        return {k: v / max(bs * steps, 1) for k, v in fisher.items()}

    @torch.no_grad()
    def after_task(self, state, task_idx, task_data):
        with torch.enable_grad():
            new = self.fisher(state, task_data)
        seen = self.init_cls_num + task_idx * self.inc_cls_num
        alpha = 1.0 - self.inc_cls_num / seen
        merged = {k: alpha * state.mvars["fisher"][k] + (1 - alpha) * v for k, v in new.items()}
        # the head's rows of the classes new in this task keep the new Fisher
        # (task 0's rows all merge: the old Fisher spans init_cls_num classes)
        old = self.init_cls_num if task_idx == 0 else seen - self.inc_cls_num
        keep = torch.arange(self.num_class, device=self.device) < old
        for k in ("head.dense.weight", "head.dense.bias"):
            rows = keep.view(-1, *([1] * (merged[k].dim() - 1)))
            merged[k] = torch.where(rows, merged[k], new[k])
        state.mvars["fisher"] = merged
        state.mvars["ref_params"] = _detached(state.params)
        return state
