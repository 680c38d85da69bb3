"""API, Adaptive Plasticity Improvement (Liang & Li, CVPR 2023)
(``libcontinual_tpu/methods/api.py``).

  * task-incremental AlexNet with DualGPM's projection: a ``remove`` layer's
    gradient loses its old-space component, a ``retain`` layer's old input
    rows freeze outright (its ``proj`` is zero, so ``P g = 0``, as the JAX
    package does); rows added by this task's expansion train free;
  * before each task after the first, the plasticity protocol: 5 epochs of
    SGD (0.01) on the kernels and the head with projected gradients, the
    batch norm and the mixes untouched, then one accumulate-only epoch; the
    per-layer ``||projected grad|| / ||raw grad||`` averaged over every
    (padded) batch of the 6 epochs is the layer's retain ratio;
  * input expansion: a layer grows ``ceil((step - retain) * K)`` input
    channels (at most its base width and the slot's ``k_slot``), mixes of
    the base channels initialised from the top singular vectors of a
    channel-importance matrix (the spectral norm of each base channel's
    kernel window, over the sampled activations);
  * after each task, DualGPM updates the spaces from the activations, after
    the new channels enter a ``retain`` layer's space as identity directions.

All capacity is preallocated (:class:`~libcontinual_tpu_torch.models.alexnet.AlexNetAPI`):
an expansion writes a slab slot and flips ``mvars["ws_mask"]``;
``mvars["old_rows"]`` marks the input rows active before the task's own
expansion. ``_feature_list``, ``_project_type`` and ``_ws_counts`` are the
host-side state.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libcontinual_tpu_torch.core.method import masked_cross_entropy
from libcontinual_tpu_torch.methods.common import batch_iter, svd
from libcontinual_tpu_torch.methods.dualgpm import dual_gpm_update
from libcontinual_tpu_torch.methods.gpm import GPM, projector
from libcontinual_tpu_torch.models.alexnet import kernel_rows, rows_to_kernel
from libcontinual_tpu_torch.registry import METHODS

BASE_IN = (3, 64, 128, 1024, 2048)
KSIZE = (4, 3, 2, 1, 1)


@METHODS.register("API")
class API(GPM):
    host_state_attrs = ("_feature_list", "_project_type", "_ws_counts")
    feat_dim = 2048

    def __init__(self, config, device):
        bb_kwargs = dict((config.get("backbone") or {}).get("kwargs") or {})
        ck = (config.get("classifier") or {}).get("kwargs") or {}
        bb_kwargs["task_num"] = int(ck.get("task_num") or config["task_num"])
        # the slab holds a task's largest expansion, ceil(step * K)
        bb_kwargs["k_slot"] = int(max(np.ceil(max(float(ck.get("step", 0.5)), 0.0)
                                              * int(ck.get("K", 10))), 1))
        config["backbone"] = {"name": "AlexNet_API", "kwargs": bb_kwargs}
        super().__init__(config, device)
        self.lame = float(self.kwargs.get("lame", 1.0))
        self.lamb = float(self.kwargs.get("lamb", 0.97))
        self.step_c = float(self.kwargs.get("step", 0.5))
        self.K = int(self.kwargs.get("K", 10))
        self.stage1_epochs = int(self.kwargs.get("stage1_epochs", 5))
        self.stage1_lr = float(self.kwargs.get("stage1_lr", 0.01))
        self.slots, self.k_slot = bb_kwargs["task_num"] - 1, bb_kwargs["k_slot"]
        e = self.slots * self.k_slot
        self.in_flats = [(3 + e) * 16, (64 + e) * 9, (128 + e) * 4, 1024 + e, 2048 + e]
        self._project_type: List[str] = []
        # active extra inputs per (layer, slot): the host's copy of ws_mask
        self._ws_counts = np.zeros((5, self.slots), np.int64)
        self.per_layer_retain = None

    def init_mvars(self, state):
        return {
            "ws_mask": self.ws_masks(self._ws_counts),
            "proj": [torch.zeros(d, d, device=self.device) for d in self.in_flats],
            "proj_sign": torch.ones(5, device=self.device),
            "old_rows": self.row_masks(self._ws_counts),
            "bn_trainable": True,
        }

    def ws_masks(self, counts) -> List[torch.Tensor]:
        """Per layer, the ``(slots, k_slot)`` 0/1 mask of the active extras."""
        ks = np.arange(self.k_slot)
        return [torch.from_numpy((ks[None, :] < counts[li][:, None]).astype(np.float32))
                .to(self.device) for li in range(5)]

    def row_masks(self, counts) -> List[torch.Tensor]:
        """Per layer, the 0/1 mask of the active input rows given the extra
        counts; rows in the flattened kernel order ``(kh, kw, C_full)``."""
        masks = []
        for li in range(5):
            base = BASE_IN[li]
            ch = np.zeros(base + self.slots * self.k_slot, np.float32)
            ch[:base] = 1.0
            for s in range(self.slots):
                lo = base + s * self.k_slot
                ch[lo: lo + int(counts[li][s])] = 1.0
            masks.append(torch.from_numpy(np.tile(ch, KSIZE[li] ** 2)).to(self.device))
        return masks

    # ----------------------------------------------------------------- step

    def project_grads(self, grads, mvars) -> List[torch.Tensor]:
        """DualGPM's projection on each layer's old input rows: remove ->
        ``g - P g``, retain -> ``P g`` (P = 0); the rows of this task's
        expansion unchanged."""
        out = []
        for li, g in enumerate(grads):
            gf = kernel_rows(g)
            projected = mvars["proj"][li] @ gf
            eff = torch.where(mvars["proj_sign"][li] > 0, gf - projected, projected)
            old = mvars["old_rows"][li][:, None]
            out.append(rows_to_kernel(old * eff + (1.0 - old) * gf, g))
        return out

    @torch.no_grad()
    def transform_grads(self, state):
        weights = state.params["backbone"].layer_weights()
        for w, g in zip(weights, self.project_grads([w.grad for w in weights], state.mvars)):
            w.grad.copy_(g)

    # ---------------------------------------------------- stage-1/2 protocol

    def stage_step(self, state, images, labels, weight, lr: float) -> torch.Tensor:
        """One protocol step: the train-mode forward without dropout, the
        per-layer projected-to-raw gradient norm ratios, and (lr > 0) SGD on
        the kernels and the head with the projected gradients."""
        x = self.augment(None, images, train=False)
        weights = state.params["backbone"].layer_weights()
        head = list(state.params["head"].parameters())
        with torch.enable_grad():
            ce = masked_cross_entropy(self.logits(state, state.params, x), labels, weight,
                                      state.seen_mask - state.prev_mask)
            grads = torch.autograd.grad(ce, weights + head)
        projected = self.project_grads(grads[:5], state.mvars)
        ratios = torch.stack([torch.linalg.vector_norm(p) /
                              torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
                              for p, g in zip(projected, grads[:5])])
        if lr > 0.0:
            for p, g in zip(weights + head, projected + list(grads[5:])):
                p.sub_(lr * g)
        return ratios

    @torch.no_grad()
    def run_stage_protocol(self, state, task_data) -> np.ndarray:
        """The stage-1 epochs and the stage-2 pass; returns the retain
        ratios (float64, one a layer). The kernels and the head train."""
        bs = int(self.config["batch_size"])
        total = torch.zeros(5, dtype=torch.float64, device=self.device)
        n_iter = 0
        for ep in range(self.stage1_epochs + 1):
            lr = self.stage1_lr if ep < self.stage1_epochs else 0.0
            for im, lb, w in batch_iter(task_data.images, task_data.labels, bs, self.device):
                total += self.stage_step(state, im, lb, w, lr).double()
                n_iter += 1
        return (total / max(n_iter, 1)).cpu().numpy()

    # ------------------------------------------------------------- expansion

    @torch.no_grad()
    def importance_bases(self, state, task_data) -> List[torch.Tensor]:
        """Per layer, the left singular vectors ``(base, .)`` of the channel
        importance matrix: the spectral norm of each base channel's kernel
        window in each sampled activation column."""
        out = []
        for li, mat in enumerate(self.activation_mats(state, task_data)):
            base, k = BASE_IN[li], KSIZE[li]
            m = mat.reshape(k, k, mat.shape[0] // (k * k), mat.shape[1])[:, :, :base]
            m = m.permute(3, 2, 0, 1)  # (cols, base, k, k)
            imp = m[..., 0, 0].abs() if k == 1 else torch.linalg.matrix_norm(m, ord=2)
            out.append(svd(imp.T, full_matrices=False)[0])
        return out

    @torch.no_grad()
    def before_task(self, state, task_idx, task_data):
        state = super().before_task(state, task_idx, task_data)  # batch norm frozen from task 1
        if task_idx == 0:
            return state
        # the protocol projects the rows of every earlier task's expansion
        state.mvars["old_rows"] = self.row_masks(self._ws_counts)
        retain = self.run_stage_protocol(state, task_data)
        self.per_layer_retain = retain
        bases = self.importance_bases(state, task_data)
        slot = task_idx - 1
        counts = self._ws_counts.copy()
        bb = state.params["backbone"]
        for li in range(5):
            expand_dim = max((self.step_c - retain[li]) * self.K, 0.0)
            size = min(max(min(int(np.ceil(expand_dim)), BASE_IN[li]), 0), self.k_slot)
            counts[li][slot] = size
            if size:
                w = torch.zeros(BASE_IN[li], self.k_slot, device=self.device)
                w[:, :size] = bases[li][:, :size].float()
                getattr(bb, f"ws{li}")[slot] = w
        self._ws_counts = counts
        state.mvars["ws_mask"] = self.ws_masks(counts)
        # the task trains with old_rows at the rows active before its expansion
        before = counts.copy()
        before[:, slot:] = 0
        state.mvars["old_rows"] = self.row_masks(before)
        return state

    # --------------------------------------------------------------- dualgpm

    def set_proj(self, state) -> None:
        """remove -> ``U U^T``; retain -> zeros (its old rows freeze)."""
        state.mvars["proj"] = [
            projector(u, d, self.device) if t == "remove"
            else torch.zeros(d, d, device=self.device)
            for u, t, d in zip(self._feature_list, self._project_type, self.in_flats)]
        state.mvars["proj_sign"] = torch.tensor(
            [1.0 if t == "remove" else -1.0 for t in self._project_type], device=self.device)

    @torch.no_grad()
    def after_task(self, state, task_idx, task_data):
        mats = self.activation_mats(state, task_data)
        if task_idx > 0 and self._feature_list:
            # this task's new channels enter a retain layer's space as
            # identity directions (rows kk * full_c + c)
            slot = task_idx - 1
            for li in range(5):
                n = int(self._ws_counts[li][slot])
                if n == 0 or self._project_type[li] != "retain":
                    continue
                k, d = KSIZE[li], self.in_flats[li]
                full_c = d // (k * k)
                c0 = BASE_IN[li] + slot * self.k_slot
                rows = [kk * full_c + c for kk in range(k * k) for c in range(c0, c0 + n)]
                eye = torch.zeros(d, len(rows), dtype=torch.float64, device=self.device)
                eye[rows, torch.arange(len(rows))] = 1.0
                self._feature_list[li] = torch.cat([self._feature_list[li], eye], dim=1)
        threshold = (self.lame - self.lamb) * task_idx / self.task_num + self.lamb
        dual_gpm_update(self._feature_list, self._project_type, mats, threshold)
        self.set_proj(state)
        return state
