"""GPM, Gradient Projection Memory (Saha et al., ICLR 2021)
(``libcontinual_tpu/methods/gpm.py``).

  * task-incremental training: CE over the current task's classes of a
    bias-less full-width head; evaluation masks the logits to the asked
    task's classes;
  * the gradients of the 5 AlexNet layers lose their component in the
    accumulated input subspace, ``g - P g`` on the flattened input rows
    (``P = U U^T``; rows in ``(kh, kw, C)`` order, :func:`kernel_rows`);
  * after each task, the layers' inputs over 125 sampled images (the conv
    inputs unfolded, of the first 24, 100 and 100 images) grow the subspace
    by an SVD at the energy threshold ``0.97 + 0.003 t``; the SVDs run in
    float64 in ``torch.linalg`` on the method's device;
  * the batch-norm parameters train on task 0 only (an update mask, so no
    weight decay reaches them).

The bases ``_feature_list`` are the host-side state (float64 tensors); the
step reads only their projections ``mvars["proj"]`` (f32).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import energy, svd, svdvals
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.alexnet import (CONV_SPECS, LAYER_IN_FLAT, conv_patches,
                                                   kernel_rows, rows_to_kernel)
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


def projector(u: torch.Tensor, dim: int, device) -> torch.Tensor:
    """``U U^T`` in f32, or zeros for an empty basis."""
    if u.numel() == 0:
        return torch.zeros(dim, dim, device=device)
    return (u @ u.T).float()


@METHODS.register("GPM")
class GPM(Method):
    n_sample = 125
    conv_batch = [24, 100, 100]
    label_smoothing = 0.0

    def __init__(self, config, device):
        super().__init__(config, device)
        self._feature_list: List[torch.Tensor] = []

    def init_state(self, seed, sample_input_hw):
        gen = make_generator(seed, "cpu")
        backbone = get_backbone(self.config, gen)
        head = LinearHead(self.feat_dim, self.num_class, generator=gen, use_bias=False)
        return self.backbone_state(backbone, head, seed, **self.extra_modules())

    def extra_modules(self):
        """Trainable modules beside the backbone and the head."""
        return {}

    def init_mvars(self, state):
        return {"proj": [torch.zeros(d, d, device=self.device) for d in LAYER_IN_FLAT],
                "bn_trainable": True}

    def before_task(self, state, task_idx, task_data):
        state.mvars["bn_trainable"] = task_idx == 0
        return state

    # ------------------------------------------------------------------ step

    def draw(self, state, batch):
        """The step's random numbers: the dropout keep masks."""
        return {"keep": state.params["backbone"].draw_keep(
            state.rng, batch["label"].shape[0], self.device)}

    def logits(self, state, params, x, keep=None, task=None):
        """The head's logits of ``x`` (the weights of task ``task``, where a
        method keeps several; the current task's by default)."""
        feats = params["backbone"](x, ws_mask=state.mvars.get("ws_mask"), keep=keep)
        return params["head"](feats["features"])

    def loss(self, state, batch):
        """CE over the current task's classes; the logits masked to them."""
        d = self.draw(state, batch)
        logits = self.logits(state, state.params, batch["x"], keep=d["keep"])
        cur = state.seen_mask - state.prev_mask
        ce = masked_cross_entropy(logits, batch["label"], batch.get("weight"), cur,
                                  self.label_smoothing)
        return ce, {"logits": torch.where(cur[None, :] > 0, logits, -1e30)}

    @torch.no_grad()
    def transform_grads(self, state):
        for w, proj in zip(state.params["backbone"].layer_weights(), state.mvars["proj"]):
            if w.grad is not None:
                rows = kernel_rows(w.grad)
                w.grad.copy_(rows_to_kernel(rows - proj @ rows, w.grad))

    def trainable_mask(self, state):
        """Batch norm frozen from task 1 on."""
        if state.mvars["bn_trainable"]:
            return None
        zero = torch.zeros((), device=self.device)
        return {p: zero for n, p in state.params["backbone"].named_parameters()
                if n.startswith("bn")}

    # -------------------------------------------------------- subspace growth

    def sample_images(self, task_data, n) -> torch.Tensor:
        """``n`` images of the task, a seeded permutation's first, eval-transformed."""
        rng = np.random.RandomState(int(self.config.get("seed", 0)))
        idx = rng.permutation(len(task_data))[:n]
        images = torch.from_numpy(np.ascontiguousarray(task_data.images[idx])).to(self.device)
        return self.augment(None, images, train=False)

    def layer_inputs(self, state, x) -> List[torch.Tensor]:
        """The projected layers' inputs, with the raw weights."""
        return state.params["backbone"](x, ws_mask=state.mvars.get("ws_mask"),
                                        capture=True)["layer_inputs"]

    @torch.no_grad()
    def activation_mats(self, state, task_data) -> List[torch.Tensor]:
        """Each layer's ``(in_flat, n)`` float64 activation matrix."""
        inputs = self.layer_inputs(state, self.sample_images(task_data, self.n_sample))
        mats = []
        for i, inp in enumerate(inputs):
            if i < len(CONV_SPECS):
                inp = conv_patches(inp[: self.conv_batch[i]], CONV_SPECS[i]["kernel"])
            mats.append(inp.double().T)
        return mats

    def set_proj(self, state) -> None:
        state.mvars["proj"] = [projector(u, d, self.device)
                               for u, d in zip(self._feature_list, LAYER_IN_FLAT)]

    @torch.no_grad()
    def after_task(self, state, task_idx, task_data):
        mats = self.activation_mats(state, task_data)
        threshold = 0.97 + task_idx * 0.003
        if task_idx == 0:
            self._feature_list = []
            for act in mats:
                u, s, _ = svd(act, full_matrices=False)
                ratio = torch.cumsum(s ** 2, 0) / torch.sum(s ** 2)
                self._feature_list.append(u[:, : int(torch.sum(ratio < threshold))])
        else:
            for i, act in enumerate(mats):
                sval_total = energy(svdvals(act))
                u_old = self._feature_list[i]
                act_hat = act - u_old @ (u_old.T @ act)
                u, s, _ = svd(act_hat, full_matrices=False)
                accumulated = (sval_total - energy(s)) / sval_total
                if accumulated >= threshold:
                    continue  # the old subspace holds enough of the energy
                ratio = (s ** 2) / sval_total
                r = int(torch.sum(torch.cumsum(ratio, 0) + accumulated < threshold)) + 1
                ui = torch.cat([u_old, u[:, :r]], dim=1)
                self._feature_list[i] = ui[:, : min(ui.shape)]
        self.set_proj(state)
        return state

    # ------------------------------------------------------------------ eval

    def eval_logits(self, state, x, task_id):
        logits = self.logits(state, state.params, x, task=state.task if task_id < 0 else task_id)
        mask = self.task_range_mask(task_id) * state.seen_mask
        return torch.where(mask[None, :] > 0, logits, -1e30)
