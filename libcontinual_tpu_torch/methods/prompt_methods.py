"""Prompt-based methods on a frozen ViT (``libcontinual_tpu/methods/prompt_methods.py``).

L2P: a pool of prompts with keys; each image's frozen-ViT CLS feature picks
its top-k keys, the batch majority picks the k prompts, those are prepended
at layer 0 of a second pass whose prompt-position mean feeds the head. The
loss is CE masked to the current task's classes minus
``pull_constraint_coeff * reduce_sim``, with gradients clipped to global
norm 1.0. Only the head and the pool train; the ViT is stored in the compute
dtype without gradients, and its query pass runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.core.optim import clip_by_global_norm
from libcontinual_tpu_torch.core.state import TrainState, make_masks
from libcontinual_tpu_torch.methods.common import normalized
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


class PromptViTMethod(Method):
    """Shared machinery: frozen ViT in ``mvars["frozen"]``, trainable head and
    prompt modules in ``params``, grad clip 1.0."""

    #: LayerNorm eps inside the blocks for the prompt family (the final norm
    #: stays at 1e-6)
    block_ln_eps = 1e-5
    max_grad_norm = 1.0

    def __init__(self, config, device):
        bk = config["backbone"].get("kwargs")
        if bk is None:
            bk = config["backbone"]["kwargs"] = {}
        bk.setdefault("block_ln_eps", self.block_ln_eps)
        super().__init__(config, device)
        self.embed_dim = int(self.kwargs.get("feat_dim", 768))

    def init_prompt_params(self, gen: torch.Generator) -> nn.Module:
        raise NotImplementedError

    def init_state(self, seed: int, sample_input_hw: Tuple[int, int, int]) -> TrainState:
        """Random init from a CPU generator seeded with ``seed``, then moved
        to the device."""
        path = ((self.config.get("backbone") or {}).get("kwargs") or {}).get("pretrained_path")
        if path and os.path.exists(os.path.expanduser(path)):
            raise NotImplementedError(
                f"pretrained_path {path!r}: loading timm weights is not in the PyTorch port yet"
            )
        gen = make_generator(seed, "cpu")
        vit = get_backbone(self.config, gen)
        head = LinearHead(self.embed_dim, self.num_class, generator=gen)
        params = nn.ModuleDict({"head": head, "prompt": self.init_prompt_params(gen)})
        return self.make_state(vit, params, seed)

    def make_state(self, vit: nn.Module, params: nn.ModuleDict, seed: int) -> TrainState:
        """State around given modules: the ViT is frozen in the compute dtype,
        the trainable modules stay f32."""
        frozen = vit.to(device=self.device, dtype=self.dtype).requires_grad_(False).eval()
        params = params.to(self.device)
        seen, prev = make_masks(self.num_class, 0, self.init_cls_num, self.device)
        return TrainState(
            params=params,
            opt_state=self._tx_for_task(0, params.parameters()),
            mvars={"frozen": frozen},
            rng=make_generator(seed, self.device),
            step=0,
            task=0,
            seen_mask=seen,
            prev_mask=prev,
        )

    def frozen_query(self, frozen: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """First pass: CLS feature of the un-prompted frozen ViT, no graph."""
        with torch.no_grad():
            return frozen(x)["features"]

    def cur_class_mask(self, state: TrainState) -> torch.Tensor:
        return state.seen_mask - state.prev_mask

    def transform_grads(self, state: TrainState) -> None:
        clip_by_global_norm(self.trainable_parameters(state), self.max_grad_norm)

    def eval_logits(self, state, x, task_id):
        logits, _ = self.forward_logits(state, x)
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)

    def forward_logits(self, state, x, weight=None):
        raise NotImplementedError


# --------------------------------------------------------------------- L2P


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties broken by
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class PromptPool(nn.Module):
    """``prompt`` (M, L, D) and ``key`` (M, D), both uniform [0, 1) at init."""

    def __init__(self, pool_size: int, length: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.prompt = nn.Parameter(torch.rand(pool_size, length, dim, generator=generator))
        self.key = nn.Parameter(torch.rand(pool_size, dim, generator=generator))


def l2p_pool_forward(pool: PromptPool, cls_feat: torch.Tensor, top_k: int,
                     weight: Optional[torch.Tensor] = None):
    """Top-k key match + batchwise-majority prompt selection; returns
    (batched prompts (B, k*len, D), reduce_sim)."""
    m = pool.key.shape[0]
    keys_n = normalized(pool.key)  # (M, D)
    q_n = normalized(cls_feat)  # (B, D)
    sim = q_n @ keys_n.T  # (B, M)
    idx = _top_k_indices(sim.detach(), top_k)  # (B, k)
    onehot = F.one_hot(idx, m).float()  # (B, k, M)
    if weight is not None:
        onehot = onehot * weight[:, None, None]
    counts = onehot.sum(dim=(0, 1))  # (M,), integer-valued: ties are common
    major = _top_k_indices(counts, top_k)  # (k,)
    sel = pool.prompt[major]  # (k, len, D)
    b = cls_feat.shape[0]
    batched = sel.reshape(1, -1, sel.shape[-1]).expand(b, -1, -1)
    key_sel = keys_n[major]  # (k, D)
    pull = torch.sum(key_sel[None, :, :] * q_n[:, None, :], dim=-1)  # (B, k)
    if weight is not None:
        reduce_sim = torch.sum(pull * weight[:, None]) / torch.clamp(weight.sum(), min=1.0)
    else:
        reduce_sim = pull.sum() / b
    return batched, reduce_sim


@METHODS.register("L2P")
class L2P(PromptViTMethod):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.pool_size = int(self.kwargs.get("pool_size", 10))
        self.length = int(self.kwargs.get("prompt_length", 5))
        self.top_k = int(self.kwargs.get("top_k", 5))
        self.coeff = float(self.kwargs.get("pull_constraint_coeff", 0.1))

    def init_prompt_params(self, gen):
        return PromptPool(self.pool_size, self.length, self.embed_dim, generator=gen)

    def forward_logits(self, state, x, weight=None):
        frozen = state.mvars["frozen"]
        cls_feat = self.frozen_query(frozen, x)
        prompts, reduce_sim = l2p_pool_forward(
            state.params["prompt"], cls_feat, self.top_k, weight
        )
        out = frozen(x, prepend_tokens=prompts, feature_mode="prompt_mean")
        return state.params["head"](out["features"]), reduce_sim

    def loss(self, state, batch):
        w = batch.get("weight")
        logits, reduce_sim = self.forward_logits(state, batch["x"], weight=w)
        masked = torch.where(self.cur_class_mask(state)[None, :] > 0, logits, -torch.inf)
        ce = masked_cross_entropy(masked, batch["label"], w)
        return ce - self.coeff * reduce_sim, {"logits": masked}
