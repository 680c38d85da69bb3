"""Prompt-based methods on a frozen ViT (``libcontinual_tpu/methods/prompt_methods.py``).

  * L2P: a pool of prompts with keys; each image's frozen-ViT CLS feature
    picks its top-k keys, the batch majority picks the k prompts, those are
    prepended at layer 0 of a second pass whose prompt-position mean feeds
    the head. The loss is CE masked to the current task's classes minus
    ``pull_constraint_coeff * reduce_sim``.
  * DualPrompt: shared g-prompts (blocks 0-1) and task-keyed e-prompts
    (blocks 2-4) as prefix keys and values; in training the task's e-prompt,
    with the matching loss ``sum(1 - cos_sim[:, task])``; in evaluation each
    image's best-matching key.
  * CODA-Prompt: per-image prompts composed from a component pool by
    attention over the query, prefix keys and values in blocks 0-4; each
    task's slice of the pool re-orthogonalised (Gram-Schmidt, on the host)
    at its start, past slices frozen by a stop-gradient blend, an optional
    orthogonality penalty ``mu``.

Gradients are clipped to global norm 1.0. Only the head and the prompts
train; the ViT is stored in the compute dtype without gradients, and its
query pass runs under ``torch.no_grad()``. DualPrompt's and CODA's prompts
are ``nn.ParameterDict``s keyed by the JAX package's names.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
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
            mvars={"frozen": frozen, **self.extra_mvars()},
            rng=make_generator(seed, self.device),
            step=0,
            task=0,
            seen_mask=seen,
            prev_mask=prev,
        )

    def extra_mvars(self) -> Dict[str, Any]:
        """Method-owned variables beside the frozen ViT."""
        return {}

    def frozen_query(self, frozen: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """First pass: CLS feature of the un-prompted frozen ViT, no graph."""
        with torch.no_grad():
            return frozen(x)["features"]

    def cur_class_mask(self, state: TrainState) -> torch.Tensor:
        return state.seen_mask - state.prev_mask

    def transform_grads(self, state: TrainState) -> None:
        clip_by_global_norm(self.trainable_parameters(state), self.max_grad_norm)

    def eval_logits(self, state, x, task_id):
        logits, _ = self.forward_logits(state, x, train=False)
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)

    def forward_logits(self, state, x, train=True, weight=None):
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

    def forward_logits(self, state, x, train=True, weight=None):
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


# --------------------------------------------------------------- DualPrompt


class PrefixPromptMethod(PromptViTMethod):
    """DualPrompt's and CODA-Prompt's loss: CE over the seen classes with the
    previous tasks' logits at -inf, plus the method's extra term
    (``forward_logits`` returns both)."""

    def loss(self, state, batch):
        w = batch.get("weight")
        logits, extra = self.forward_logits(state, batch["x"], train=True, weight=w)
        masked = torch.where(state.prev_mask[None, :] > 0, -torch.inf, logits)
        ce = masked_cross_entropy(masked, batch["label"], w, state.seen_mask)
        return ce + extra, {"logits": masked}


def _uniform(shape, gen) -> nn.Parameter:
    return nn.Parameter(torch.rand(*shape, generator=gen))


@METHODS.register("DualPrompt")
class DualPrompt(PrefixPromptMethod):
    G_LAYERS = (0, 1)
    E_LAYERS = (2, 3, 4)

    def __init__(self, config, device):
        super().__init__(config, device)
        self.e_len = int(self.kwargs.get("e_prompt_length", 20))
        self.g_len = int(self.kwargs.get("g_prompt_length", 6))
        self.pool_size = int(self.kwargs.get("pool_size", 10))
        if self.e_len % 2 or self.g_len % 2:
            raise ValueError(
                "DualPrompt e_prompt_length/g_prompt_length must be even "
                f"(got e={self.e_len}, g={self.g_len}): each prompt is "
                "split into equal K and V halves"
            )

    def init_prompt_params(self, gen):
        """``g_p_{l}`` (g_len, D); ``e_p_{l}`` (pool, e_len, D) and ``e_k_{l}``
        (pool, D); all uniform [0, 1)."""
        p = nn.ParameterDict()
        for g in self.G_LAYERS:
            p[f"g_p_{g}"] = _uniform((self.g_len, self.embed_dim), gen)
        for e in self.E_LAYERS:
            p[f"e_p_{e}"] = _uniform((self.pool_size, self.e_len, self.embed_dim), gen)
            p[f"e_k_{e}"] = _uniform((self.pool_size, self.embed_dim), gen)
        return p

    def prefixes(self, prompt, q, task: int, train: bool, weight=None):
        """Per-block (pk, pv) prefixes and the matching loss. In training the
        prompts are broadcast over the batch (batch stride 0)."""
        b = q.shape[0]
        prefix_kv = {}
        match_loss = 0.0
        q_n = normalized(q).detach()
        for g in self.G_LAYERS:
            gp = prompt[f"g_p_{g}"]
            half = self.g_len // 2
            prefix_kv[g] = (gp[None, :half].expand(b, -1, -1), gp[None, half:].expand(b, -1, -1))
        for e in self.E_LAYERS:
            pool = prompt[f"e_p_{e}"]
            cos = q_n @ normalized(prompt[f"e_k_{e}"]).T  # (B, pool)
            if train:
                sel = pool[task][None].expand(b, -1, -1)
                picked = 1.0 - cos[:, task]
                match_loss = match_loss + (
                    torch.sum(picked * weight) if weight is not None else torch.sum(picked)
                )
            else:
                sel = pool[cos.argmax(dim=1)]  # (B, e_len, D): each image's own
            half = self.e_len // 2
            prefix_kv[e] = (sel[:, :half], sel[:, half:])
        return prefix_kv, match_loss

    def forward_logits(self, state, x, train=True, weight=None):
        frozen = state.mvars["frozen"]
        q = self.frozen_query(frozen, x)
        prefix_kv, match_loss = self.prefixes(state.params["prompt"], q, state.task, train, weight)
        out = frozen(x, prefix_kv=prefix_kv)
        return state.params["head"](out["features"]), match_loss


# -------------------------------------------------------------- CODA-Prompt


def _gram_schmidt_block(mat: np.ndarray, s: int, f: int, rng: np.random.RandomState):
    """Re-init rows [s:f) orthonormal to rows [0:s): a fresh normal draw per
    row, orthogonalised in float64 (the JAX package's host-side routine, so
    the same ``rng`` gives the same rows)."""
    m = mat.reshape(mat.shape[0], -1).astype(np.float64)
    for k in range(s, f):
        while True:
            v = rng.randn(m.shape[1])
            for j in range(k):
                u = m[j]
                den = u @ u
                if den > 1e-8:
                    v = v - (v @ u) / den * u
            n = np.linalg.norm(v)
            if n > 1e-8:
                m[k] = v / n
                break
    return m.reshape(mat.shape).astype(np.float32)


@METHODS.register("CodaPrompt")
class CodaPrompt(PrefixPromptMethod):
    E_LAYERS = (0, 1, 2, 3, 4)

    def __init__(self, config, device):
        super().__init__(config, device)
        self.pool_size = int(self.kwargs.get("pool_size", 100))
        self.length = int(self.kwargs.get("prompt_length", 8))
        self.mu = float(self.kwargs.get("mu", 0.0))
        self.key_d = self.embed_dim
        if self.length % 2:
            raise ValueError(
                f"CodaPrompt prompt_length must be even (got {self.length}): "
                "composed prompts split into equal K and V halves"
            )

    def _per_task(self) -> int:
        return self.pool_size // self.task_num

    def init_prompt_params(self, gen):
        """``e_p_{l}`` (pool, length, D), ``e_k_{l}`` and ``e_a_{l}`` (pool, D):
        normal draws from ``np.random.RandomState(0)``, the first task's rows
        orthonormalised, exactly as the JAX package draws them (``gen`` is
        not used)."""
        r = np.random.RandomState(0)
        pt = self._per_task()
        p = nn.ParameterDict()
        for e in self.E_LAYERS:
            for name, shape in ((f"e_p_{e}", (self.pool_size, self.length, self.embed_dim)),
                                (f"e_k_{e}", (self.pool_size, self.key_d)),
                                (f"e_a_{e}", (self.pool_size, self.key_d))):
                block = _gram_schmidt_block(r.randn(*shape).astype(np.float32), 0, pt, r)
                p[name] = nn.Parameter(torch.from_numpy(block))
        return p

    def before_task(self, state, task_idx, task_data):
        """Re-orthogonalise the task's rows of every pool tensor, in place."""
        if task_idx == 0:
            return state
        pt = self._per_task()
        s, f = task_idx * pt, (task_idx + 1) * pt
        rng = np.random.RandomState(task_idx)
        prompt = state.params["prompt"]
        with torch.no_grad():
            for e in self.E_LAYERS:
                for nm in (f"e_p_{e}", f"e_k_{e}", f"e_a_{e}"):
                    t = prompt[nm]
                    block = _gram_schmidt_block(t.detach().cpu().numpy(), s, f, rng)
                    t.copy_(torch.from_numpy(block))
        return state

    def _component_masks(self, task: int):
        """(pool, 1) masks of the frozen (past) and valid (up to this task's)
        components, and the count of valid ones."""
        pt = self._per_task()
        idx = torch.arange(self.pool_size, device=self.device)
        frozen = (idx < task * pt).float()
        valid = (idx < (task + 1) * pt).float()
        return frozen[:, None], valid[:, None], float((task + 1) * pt)

    def _layer_prompt(self, prompt, e, q, frozen_m, valid_m, train):
        K, A, P = prompt[f"e_k_{e}"], prompt[f"e_a_{e}"], prompt[f"e_p_{e}"]
        if train:
            def blend(t):
                m = frozen_m.reshape((-1,) + (1,) * (t.dim() - 1))
                return t.detach() * m + t * (1 - m)

            K, A, P = blend(K), blend(A), blend(P)
        a_query = torch.einsum("bd,kd->bkd", q, A)
        aq_k = torch.einsum("bkd,kd->bk", normalized(a_query, dim=2), normalized(K))
        aq_k = aq_k * valid_m[:, 0][None, :]
        composed = torch.einsum("bk,kld->bld", aq_k, P)  # (B, length, D), per image
        half = self.length // 2
        return (composed[:, :half], composed[:, half:]), (K, A, P)

    @staticmethod
    def _ortho(M, valid_m, f):
        Mv = M.reshape(M.shape[0], -1) * valid_m
        G = Mv @ Mv.T
        eye = torch.diag(valid_m[:, 0])
        return torch.sum((G - eye) ** 2) / max(f * f, 1.0)

    def forward_logits(self, state, x, train=True, weight=None):
        frozen = state.mvars["frozen"]
        q = self.frozen_query(frozen, x)
        frozen_m, valid_m, f = self._component_masks(state.task)
        prefix_kv = {}
        ortho = 0.0
        for e in self.E_LAYERS:
            prefix_kv[e], (K, A, P) = self._layer_prompt(
                state.params["prompt"], e, q, frozen_m, valid_m, train
            )
            if train and self.mu > 0:
                ortho = ortho + self.mu * (
                    self._ortho(K, valid_m, f) + self._ortho(A, valid_m, f)
                    + self._ortho(P, valid_m, f)
                )
        out = frozen(x, prefix_kv=prefix_kv)
        return state.params["head"](out["features"]), ortho
