"""DAP, Dynamically Anchored Prompting for task-imbalanced continual
learning (``libcontinual_tpu/methods/dap.py``).

  * Per-task prompts and one general prompt, prepended to the frozen ViT's
    tokens at layer 0 (the packed-qkv attention path, as L2P's).
  * The general prompt is anchored between the newest task prompt (the
    plasticity term ``1 - cos(g, t_cur)``) and a prompt centre weighted by
    the inverse task sizes (the stability term), mixed by
    ``alpha = (n_last - n_min) / (n_max - n_min)``. Both ``alpha`` and the
    centre are set on the host by ``before_task`` from the task sizes seen so
    far, and live in ``mvars``.
  * CE masked to the current task's classes, through both the task prompt
    and the general prompt; evaluation uses the general prompt.
  * It trains on the long-tailed streams of ``imb_type`` / ``imb_factor``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from libcontinual_tpu_torch.core.method import masked_cross_entropy
from libcontinual_tpu_torch.methods.prompt_methods import PromptViTMethod
from libcontinual_tpu_torch.registry import METHODS


def _cos_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    na = torch.linalg.vector_norm(a) + 1e-8
    nb = torch.linalg.vector_norm(b) + 1e-8
    return 1.0 - torch.dot(a, b) / (na * nb)


@METHODS.register("DAP")
class DAP(PromptViTMethod):
    block_ln_eps = 1e-6  # DAP's ViT is a timm one

    def __init__(self, config, device):
        super().__init__(config, device)
        self.length = int(self.kwargs.get("length", 5))
        self.top_k = int(self.kwargs.get("top_k", 1))
        self._task_counts = []

    def init_prompt_params(self, gen):
        """``taskprompt`` (tasks, top_k * length, D) and ``generalprompt``
        (top_k * length, D), uniform [-1, 1)."""
        p = self.top_k * self.length
        return nn.ParameterDict({
            "taskprompt": nn.Parameter(
                torch.rand(self.task_num, p, self.embed_dim, generator=gen) * 2.0 - 1.0),
            "generalprompt": nn.Parameter(
                torch.rand(p, self.embed_dim, generator=gen) * 2.0 - 1.0),
        })

    def extra_mvars(self):
        return {
            "alpha": torch.zeros((), device=self.device),
            "prompt_center": torch.zeros(self.top_k * self.length * self.embed_dim,
                                         device=self.device),
        }

    def before_task(self, state, task_idx, task_data):
        """``alpha`` from the task sizes so far; from task 1 on, the prompt
        centre over the past task prompts, weighted by inverse task size."""
        self._task_counts.append(len(task_data))
        counts = np.asarray(self._task_counts, np.float64)
        alpha = (counts[-1] - counts.min()) / (counts.max() - counts.min() + 1e-10)
        state.mvars["alpha"] = torch.tensor(alpha, dtype=torch.float32, device=self.device)
        if task_idx > 0:
            w = 1.0 / counts[:task_idx]
            w = w / w.sum()
            tp = state.params["prompt"]["taskprompt"][:task_idx].detach().cpu().numpy()
            center = np.einsum("t,tpd->pd", w, tp).reshape(-1)
            state.mvars["prompt_center"] = torch.as_tensor(
                center, dtype=torch.float32).to(self.device)
        return state

    def _prompted(self, state, x, prompt_tokens):
        toks = prompt_tokens[None].expand(x.shape[0], -1, -1)
        out = state.mvars["frozen"](x, prepend_tokens=toks, feature_mode="prompt_mean")
        return state.params["head"](out["features"])

    def forward_logits(self, state, x, train=True, weight=None):
        """Logits through the current task's prompt (a bare tensor, as in the
        JAX package)."""
        return self._prompted(state, x, state.params["prompt"]["taskprompt"][state.task])

    def loss(self, state, batch):
        w = batch.get("weight")
        prompt = state.params["prompt"]
        cur = self.cur_class_mask(state)[None, :] > 0

        t_masked = torch.where(cur, self.forward_logits(state, batch["x"]), -torch.inf)
        ce_t = masked_cross_entropy(t_masked, batch["label"], w)
        g_masked = torch.where(cur, self._prompted(state, batch["x"], prompt["generalprompt"]),
                               -torch.inf)
        ce_g = masked_cross_entropy(g_masked, batch["label"], w)

        g = prompt["generalprompt"].reshape(-1)
        t_cur = prompt["taskprompt"][state.task].detach().reshape(-1)
        pla = _cos_dist(g, t_cur)
        sta = _cos_dist(g, state.mvars["prompt_center"]) if state.task > 0 else 0.0
        alpha = state.mvars["alpha"]
        loss = ce_t + ce_g + alpha * sta + (1 - alpha) * pla
        return loss, {"logits": t_masked}

    def eval_logits(self, state, x, task_id):
        logits = self._prompted(state, x, state.params["prompt"]["generalprompt"])
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)
