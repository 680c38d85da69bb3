"""BiC, Bias Correction (Wu et al., CVPR 2019) (``libcontinual_tpu/methods/bic.py``).

  * stage 1: ``alpha * KD * T^2 + (1 - alpha) * CE`` with ``alpha = old /
    seen`` (CE alone at task 0), both on the bias-corrected logits and the KD
    against the network frozen after the previous task (in train mode on the
    batch's statistics unless ``teacher_batch_stats: false``);
  * per-task bias layers ``alpha_t * logit + beta_t`` over task t's classes
    (:func:`~libcontinual_tpu_torch.models.heads.bias_correct`), two
    ``(task_num,)`` tensors in ``mvars``;
  * the optimizer is momentum-0.9 SGD without the config's decay, at lr 0.1
    with MultiStepLR [100, 150, 200]; the decay ``2e-4 * task_num / (t + 1)``
    is added to the gradients in ``transform_grads``;
  * the held-out split: ``build_train_data`` keeps ``split_ratio`` of each
    class of the task's images (``RandomState(seed * 1000 + t)``) and the
    buffer's validation part (``LinearSpiltBuffer.split``) out of stage 1;
  * stage 2 (``extra_phases``, t > 0): Adam (lr 1e-3) on the task's
    (alpha_t, beta_t) over the held-out data, ``stage2_epoch`` epochs in
    batches of 100, each in the order of ``RandomState(seed + t)``'s
    permutations, the network in eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.core.optim import ScheduleController
from libcontinual_tpu_torch.data.continual import TaskData
from libcontinual_tpu_torch.methods.common import batch_iter, kd_loss, snapshot
from libcontinual_tpu_torch.models.heads import bias_correct
from libcontinual_tpu_torch.registry import METHODS


def split_task(task_data: TaskData, ratio: float, rng: np.random.RandomState):
    """(train part, held-out part) of a task: ``ratio`` of each class's
    images, at least one, none of a one-image class; a part may be None."""
    tr_idx, va_idx = [], []
    for c in np.unique(task_data.labels):
        idx = np.nonzero(task_data.labels == c)[0]
        rng.shuffle(idx)
        n_val = max(1, int(len(idx) * ratio)) if len(idx) > 1 else 0
        va_idx.append(idx[:n_val])
        tr_idx.append(idx[n_val:])

    def part(idx):
        idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        if len(idx) == 0:
            return None
        return TaskData(images=task_data.images[idx], labels=task_data.labels[idx],
                        class_lo=task_data.class_lo, class_hi=task_data.class_hi)

    return part(tr_idx), part(va_idx)


def _join(a, b):
    return b if a is None else a if b is None else a.concat(b)


@METHODS.register("bic")
class BiC(Method):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.T = float(self.kwargs.get("T", 2.0))
        self.stage2_epoch = int(config.get("stage2_epoch", self.kwargs.get("stage2_epoch", 50)))
        self.split_ratio = float(self.kwargs.get("split_ratio", 0.1))
        toc = torch.zeros(self.num_class, dtype=torch.int64)
        for t in range(self.task_num):
            lo, hi = self.class_range(t)
            toc[lo:hi] = t
        self.task_of_class = toc.to(self.device)
        self.stage2_data = None
        self.stage2_losses = []

    def _tx_for_task(self, task_idx, params):
        return torch.optim.SGD(list(params), lr=0.0, momentum=0.9)

    def override_schedule(self, task_idx, steps_per_epoch, epochs):
        cfg = {"lr_scheduler": {"name": "MultiStepLR",
                                "kwargs": {"milestones": [100, 150, 200], "gamma": 0.1}}}
        return ScheduleController(cfg, 0.1, steps_per_epoch, epochs)

    def init_mvars(self, state):
        return {
            "teacher": snapshot(state.params),
            "alphas": torch.ones(self.task_num, device=self.device),
            "betas": torch.zeros(self.task_num, device=self.device),
            "wd": 2e-4 * self.task_num,
        }

    def build_train_data(self, task_data, buffer, task_idx):
        """Stage 1's data; the held-out part waits in ``stage2_data``."""
        seed = int(self.config.get("seed", 0))
        train, val = split_task(task_data, self.split_ratio,
                                np.random.RandomState(seed * 1000 + task_idx))
        if (getattr(buffer, "split", None) is not None and buffer.buffer_size > 0
                and task_idx > 0 and len(buffer) > 0):
            b_train, b_val = buffer.split(seed=seed + task_idx)
            train, val = _join(train, b_train), _join(val, b_val)
        self.stage2_data = val
        return train

    def before_task(self, state, task_idx, task_data):
        state.mvars["wd"] = 2e-4 * self.task_num / (task_idx + 1)
        state.mvars["alphas"][task_idx] = 1.0
        state.mvars["betas"][task_idx] = 0.0
        return state

    @torch.no_grad()
    def transform_grads(self, state):
        wd = state.mvars["wd"]
        for p in state.params.parameters():
            if p.grad is None:
                p.grad = wd * p.detach().clone()
            else:
                p.grad.add_(p, alpha=wd)

    def _biased(self, logits, alphas, betas):
        return bias_correct(logits, alphas, betas, self.task_of_class)

    def loss(self, state, batch):
        mv = state.mvars
        logits, _ = self.forward(state.params, batch["x"], train=True)
        p = self._biased(logits, mv["alphas"], mv["betas"])
        w = batch.get("weight")
        ce = masked_cross_entropy(p, batch["label"], w, state.seen_mask)
        if state.task == 0:
            return ce, {"logits": p}
        with torch.no_grad():
            t_logits, _ = self.forward(mv["teacher"], batch["x"], train=self.teacher_train,
                                       update_stats=False)
            tp = self._biased(t_logits, mv["alphas"], mv["betas"])
        kd = kd_loss(p, tp, T=self.T, class_mask=state.prev_mask, weight=w)
        alpha = state.prev_mask.sum() / torch.clamp(state.seen_mask.sum(), min=1.0)
        return alpha * kd * self.T ** 2 + (1.0 - alpha) * ce, {"logits": p}

    def after_task(self, state, task_idx, task_data):
        state.mvars["teacher"] = snapshot(state.params)
        return state

    def extra_phases(self, trainer, state, task_idx, task_data):
        """Stage 2 on the held-out data; its losses land in ``stage2_losses``."""
        held = self.stage2_data
        if task_idx == 0 or held is None or len(held) == 0:
            return state
        rng = np.random.RandomState(int(self.config.get("seed", 0)) + task_idx)
        mv = state.mvars
        ab = torch.stack([mv["alphas"][task_idx], mv["betas"][task_idx]]).clone()
        ab.requires_grad_(True)
        opt = torch.optim.Adam([ab], lr=1e-3)
        onehot = torch.arange(self.task_num, device=self.device) == task_idx
        bs = int(self.kwargs.get("stage2_batch_size", 100))
        self.stage2_losses = []
        for _ in range(self.stage2_epoch):
            order = rng.permutation(len(held.labels))
            for im, lb, w in batch_iter(held.images[order], held.labels[order], bs, self.device):
                with torch.no_grad():
                    x = self.augment(None, im, train=False)
                    logits, _ = self.forward(state.params, x, train=False)
                alphas = torch.where(onehot, ab[0], mv["alphas"])
                betas = torch.where(onehot, ab[1], mv["betas"])
                loss = masked_cross_entropy(self._biased(logits, alphas, betas), lb, w,
                                            state.seen_mask)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                self.stage2_losses.append(loss.detach())
        self.stage2_losses = torch.stack(self.stage2_losses).tolist()
        with torch.no_grad():
            mv["alphas"][task_idx] = ab[0]
            mv["betas"][task_idx] = ab[1]
        return state

    def eval_logits(self, state, x, task_id):
        logits, _ = self.forward(state.params, x, train=False)
        p = self._biased(logits, state.mvars["alphas"], state.mvars["betas"])
        return torch.where(state.seen_mask[None, :] > 0, p, -1e30)
