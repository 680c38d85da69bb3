"""TRGP, Trust Region Gradient Projection (Lin et al., ICLR 2022)
(``libcontinual_tpu/methods/trgp.py``), the AlexNet branch.

  * GPM's projection out of the accumulated subspace, with TRGP's growth
    ranked by ``delta`` (the old basis's captured energy per direction) and
    ``sigma`` (the residual's) together;
  * before each task after the first, one gradient over 125 images picks,
    per layer, the (at most 2) past tasks whose subspace holds more than
    ``EPSILON`` of the gradient's norm: the trust region;
  * learnable scale matrices Q on those subspaces re-parameterize each
    layer, ``W <- W + (W U)(Q - I)U^T`` for each of the two in order; only
    the current task's scales train, and each task's scales and spaces
    rebuild its weights at (task-aware) evaluation;
  * label smoothing (``label_smoothing``); no validation between epochs.

The spaces are padded to ``R_CAP`` columns and stacked, ``(T, 2, in_flat,
R_CAP)`` (``mvars["tr_space"]``), the scales ``(T, 2, R_CAP, R_CAP)``
(``params["tr_scale"]``, identity at start). ``_task_spaces`` holds each
task's float64 subspaces, the state the next tasks' trust regions read.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from libcontinual_tpu_torch.core.method import masked_cross_entropy
from libcontinual_tpu_torch.methods.common import energy, svd, svdvals
from libcontinual_tpu_torch.methods.gpm import GPM
from libcontinual_tpu_torch.models.alexnet import LAYER_IN_FLAT, kernel_rows, rows_to_kernel
from libcontinual_tpu_torch.registry import METHODS


@METHODS.register("TRGP")
def make_trgp(config, device):
    """TRGP on AlexNet; the CLIP variant is not ported yet."""
    if "clip" in str(config["backbone"]["name"]).lower():
        raise NotImplementedError(
            "TRGP on CLIP (TRGP_CLIP) is not in the PyTorch port yet "
            "(ROADMAP.md, Queue 1 item 8b: the CLIP half of gradient projection)"
        )
    return TRGP(config, device)


class TRGP(GPM):
    validate_enabled = False
    R_CAP = 128  # padded trust-region rank per (task, layer, slot)
    EPSILON = 0.5

    def __init__(self, config, device):
        super().__init__(config, device)
        self.label_smoothing = float(self.kwargs.get("label_smoothing", 0.0))
        self._task_spaces: List[List[torch.Tensor]] = [
            [torch.zeros(d, 0, dtype=torch.float64, device=self.device) for d in LAYER_IN_FLAT]
            for _ in range(self.task_num)]
        #: per layer, the past tasks of the current trust region
        self.selected: List[List[int]] = [[] for _ in LAYER_IN_FLAT]

    def extra_modules(self):
        t, r = self.task_num, self.R_CAP
        return {"tr_scale": nn.ParameterList(
            nn.Parameter(torch.eye(r).expand(t, 2, r, r).clone()) for _ in LAYER_IN_FLAT)}

    def init_mvars(self, state):
        mv = super().init_mvars(state)
        t, r = self.task_num, self.R_CAP
        mv["tr_space"] = [torch.zeros(t, 2, d, r, device=self.device) for d in LAYER_IN_FLAT]
        return mv

    # ---------------------------------------------------------------- forward

    def effective_weights(self, params, mvars, task: int) -> List[torch.Tensor]:
        """Each layer's weight under task ``task``'s trust-region scales."""
        eye = torch.eye(self.R_CAP, device=self.device)
        weights = []
        for li, w in enumerate(params["backbone"].layer_weights()):
            wf = kernel_rows(w).T  # (out, in_flat)
            spaces, scales = mvars["tr_space"][li][task], params["tr_scale"][li][task]
            for j in range(2):
                u = spaces[j]
                wf = wf + (wf @ u) @ (scales[j] - eye) @ u.T
            weights.append(rows_to_kernel(wf.T, w))
        return weights

    def logits(self, state, params, x, keep=None, task=None):
        wo = self.effective_weights(params, state.mvars, state.task if task is None else task)
        return params["head"](params["backbone"](x, weight_override=wo, keep=keep)["features"])

    @torch.no_grad()
    def transform_grads(self, state):
        super().transform_grads(state)  # GPM's projection
        t = state.task
        for p in state.params["tr_scale"]:  # only the current task's scales train
            if p.grad is not None:
                p.grad[:t].zero_()
                p.grad[t + 1:].zero_()

    # ----------------------------------------------------------------- hooks

    @torch.no_grad()
    def before_task(self, state, task_idx, task_data):
        state = super().before_task(state, task_idx, task_data)
        if task_idx == 0:
            return state
        # the trust region from one 125-image gradient
        rng = np.random.RandomState(task_idx)
        idx = rng.permutation(len(task_data))[:125]
        images = torch.from_numpy(np.ascontiguousarray(task_data.images[idx])).to(self.device)
        labels = torch.from_numpy(task_data.labels[idx].astype(np.int64)).to(self.device)
        x = self.augment(None, images, train=False)
        weights = state.params["backbone"].layer_weights()
        with torch.enable_grad():
            ce = masked_cross_entropy(self.logits(state, state.params, x), labels, None,
                                      state.seen_mask - state.prev_mask)
            grads = torch.autograd.grad(ce, weights)
        for li, g in enumerate(grads):
            gm = kernel_rows(g).T.double()  # (out, in_flat)
            gnorm = float(torch.linalg.norm(gm))
            cands = []
            for t in range(task_idx):
                u = self._task_spaces[t][li]
                if u.shape[1] == 0:
                    continue
                pn = float(torch.linalg.norm((gm @ u) @ u.T))
                if pn > self.EPSILON * gnorm:
                    cands.append((pn, t))
            cands.sort(reverse=True)
            self.selected[li] = [t for _, t in cands[:2]]
            block = torch.zeros(2, LAYER_IN_FLAT[li], self.R_CAP, device=self.device)
            for j, t in enumerate(self.selected[li]):
                u = self._task_spaces[t][li][:, : self.R_CAP]
                block[j, :, : u.shape[1]] = u.float()
            state.mvars["tr_space"][li][task_idx] = block
            # the task's scales start at the identity
            state.params["tr_scale"][li][task_idx] = torch.eye(self.R_CAP, device=self.device)
        return state

    @torch.no_grad()
    def after_task(self, state, task_idx, task_data):
        """The subspace growth, ranked by delta and sigma together."""
        mats = self.activation_mats(state, task_data)
        threshold = 0.97 + task_idx * 0.003
        if task_idx == 0:
            self._feature_list = []
            for li, act in enumerate(mats):
                u, s, _ = svd(act, full_matrices=False)
                ratio = torch.cumsum(s ** 2, 0) / torch.sum(s ** 2)
                u = u[:, : int(torch.sum(ratio < threshold))]
                self._feature_list.append(u)
                self._task_spaces[0][li] = u
        else:
            for li, act in enumerate(mats):
                sval_total = energy(svdvals(act))
                f = self._feature_list[li]
                proj = f.T @ act
                delta = torch.sum(proj * proj, dim=1)  # diag(F^T A A^T F)
                u, s, _ = svd(act - f @ proj, full_matrices=False)
                stack = torch.cat([delta, s ** 2])
                # descending, as numpy's argsort(...)[::-1]
                order = torch.argsort(stack, stable=True).flip(0)
                if threshold * sval_total <= 0:
                    r = 0
                else:
                    cum = torch.cumsum(stack[order], 0)
                    r = min(int(torch.sum(cum < threshold * sval_total)) + 1, act.shape[0])
                ui = torch.cat([f, u], dim=1)
                sel_each = order[:r]
                sel_overall = sel_each[sel_each >= len(delta)]
                self._feature_list[li] = torch.cat([f, ui[:, sel_overall]], dim=1)
                self._task_spaces[task_idx][li] = ui[:, sel_each]
        self.set_proj(state)
        return state
