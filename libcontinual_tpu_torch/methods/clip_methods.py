"""CLIP-based methods: MoE-Adapter4CL and RAPF
(``libcontinual_tpu/methods/clip_methods.py``).

  * MoE-Adapter4CL: a frozen CLIP with mixture-of-adapter-experts blocks in
    both towers (noisy top-k gating, a cv^2 load-balancing term); each step
    contrasts the images with the prompts of all classes ("a photo of a
    {}."), CE masked to the current task's classes; evaluation scores the
    seen classes. Only the experts and ``logit_scale`` train: the other
    parameters carry ``requires_grad=False``, so the optimizer sees exactly
    the leaves the JAX package's split trains.
  * RAPF: a frozen CLIP and a bias-free linear adapter on the image
    features, trained against the class prompts' text features with one CE
    over the current images and Gaussian-replayed old features, plus a hinge
    on edge samples of "hard" (old, new) class pairs; after each task the
    per-class means and Cholesky factors of the feature covariances are
    recorded and the adapter is fused with the previous one (``mix_matrix``).

The random draws of a step (the experts' gate noise and dropout, RAPF's
replay and edge noise) come from the state's generator on the device; they
cannot reproduce ``jax.random``'s bits, only its distributions.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.core.state import TrainState, make_masks
from libcontinual_tpu_torch.methods.common import batch_iter, copy_tree, normalized
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.clip import CLIP, load_clip_torch_weights
from libcontinual_tpu_torch.models.tokenizer import tokenize
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


class CLIPMethod(Method):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.prompt_template = self.kwargs.get("prompt_template", "a photo of a {}.")
        self.class_names: List[str] = []

    def _backbone_kind(self):
        return "clip"

    def build_clip(self, gen: torch.Generator) -> CLIP:
        """Random init from ``gen`` (on the CPU), then a local OpenAI
        checkpoint when ``backbone.kwargs.pretrained_path`` names an existing
        file; in f32 on the method's device."""
        clip = get_backbone(self.config, gen)
        path = ((self.config.get("backbone") or {}).get("kwargs") or {}).get("pretrained_path")
        if path and os.path.exists(path):
            load_clip_torch_weights(clip, path)
        return clip.to(self.device)

    def class_tokens(self, lo: int, hi: int) -> torch.Tensor:
        names = [
            self.class_names[c] if c < len(self.class_names) and self.class_names[c]
            else f"class {c}"
            for c in range(lo, hi)
        ]
        toks = tokenize([self.prompt_template.format(n) for n in names])
        return torch.from_numpy(toks.astype(np.int64)).to(self.device)


@METHODS.register("MOE_ADAPTER4CL", aliases=("MoE_Adapter4CL",))
def make_moe_adapter4cl(config, device):
    """MoE-Adapter4CL on CLIP; the ViT branch is not ported yet."""
    if "clip" in str(config["backbone"]["name"]).lower():
        return MoEAdapter4CL(config, device)
    raise NotImplementedError(
        "MoE-Adapter4CL on a ViT (MoEAdapter4CLViT) is not in the PyTorch port yet "
        "(ROADMAP.md, Queue 1 item 4: what stays of the CLIP family)"
    )


def _backbone_kwargs(config):
    bk = config["backbone"].get("kwargs")
    if bk is None:
        bk = config["backbone"]["kwargs"] = {}
    return bk


class MoEAdapter4CL(CLIPMethod):
    def __init__(self, config, device):
        bk = _backbone_kwargs(config)
        bk.setdefault("moe_experts", bk.get("experts_num", 4))
        super().__init__(config, device)
        self.label_smoothing = float(self.kwargs.get("label_smoothing", 0.0))
        # the cv^2 load-balancing term weighs 0 unless configured
        self.aux_weight = float(self.kwargs.get("load_balance_weight", 0.0))

    @staticmethod
    def is_trainable(name: str) -> bool:
        """The JAX package's split: every leaf under a ``moe`` (or
        ``adaptmlp``) module, and ``logit_scale``."""
        parts = name.split(".")
        return any("moe" in p or "adaptmlp" in p for p in parts[:-1]) or "logit_scale" in parts[-1]

    def init_state(self, seed, sample_input_hw) -> TrainState:
        return self.make_state(self.build_clip(make_generator(seed, "cpu")), seed)

    def make_state(self, clip: CLIP, seed: int) -> TrainState:
        clip = clip.to(self.device)
        for name, p in clip.named_parameters():
            p.requires_grad_(self.is_trainable(name))
        params = nn.ModuleDict({"clip": clip})
        seen, prev = make_masks(self.num_class, 0, self.init_cls_num, self.device)
        return TrainState(
            params=params,
            opt_state=self._tx_for_task(0, [p for p in params.parameters() if p.requires_grad]),
            mvars={"task_tokens": self.class_tokens(0, self.num_class)},
            rng=make_generator(seed, self.device),
            step=0,
            task=0,
            seen_mask=seen,
            prev_mask=prev,
        )

    def before_task(self, state, task_idx, task_data):
        state.mvars["task_tokens"] = self.class_tokens(0, self.num_class)
        return state

    def moe_generator(self, state: TrainState) -> Optional[torch.Generator]:
        """Where a training forward draws the experts' gate noise and dropout."""
        return state.rng

    def loss(self, state, batch):
        out = state.params["clip"](batch["x"], state.mvars["task_tokens"],
                                   moe_gen=self.moe_generator(state))
        logits = out["logits_per_image"]  # (B, num_class) against all class prompts
        cur_mask = state.seen_mask - state.prev_mask
        ce = masked_cross_entropy(logits, batch["label"], batch.get("weight"), cur_mask,
                                  self.label_smoothing)
        loss = ce + self.aux_weight * out["moe_aux"]
        return loss, {"logits": torch.where(cur_mask[None, :] > 0, logits, -1e30)}

    def eval_logits(self, state, x, task_id):
        logits = state.params["clip"](x, state.mvars["task_tokens"])["logits_per_image"]
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)


# --------------------------------------------------------------------- RAPF


def shrink_cov(cov: np.ndarray) -> np.ndarray:
    """Covariance shrinkage: add the mean diagonal to the diagonal and the
    mean non-zero off-diagonal entry to the off-diagonal."""
    d = cov.shape[0]
    diag_mean = float(np.mean(np.diagonal(cov)))
    off = cov.copy()
    np.fill_diagonal(off, 0.0)
    mask = off != 0.0
    off_mean = float(off[mask].sum() / max(mask.sum(), 1))
    iden = np.eye(d)
    return cov + diag_mean * iden + off_mean * (1.0 - iden)


def mix_matrix(W_old: np.ndarray, W_new: np.ndarray, mix_bias: float) -> np.ndarray:
    """Parameter fusion in torch's weight layout (out, in): express W_new in
    W_old's left-singular basis and blend each coefficient toward the old one
    by (1 - normalised drift - mix_bias)."""
    U, S, Vt = np.linalg.svd(W_old, full_matrices=False)
    P_new = U.T @ W_new
    SV = np.diag(S) @ Vt
    drift = np.abs(P_new - SV)
    mask = np.minimum(drift / max(drift.max(), 1e-12) + mix_bias, 1.0)
    return U @ (P_new * mask + SV * (1.0 - mask))


@METHODS.register("RAPF")
class RAPF(CLIPMethod):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.embed_dim = int(self.kwargs.get("embed_dim", 512))
        self.beta = float(self.kwargs.get("beta", 2.0))
        self.shrinkage = bool(self.kwargs.get("shrinkage", False))
        self.threshold = float(self.kwargs.get("threshold", 0.55))
        self.mix_bias = float(self.kwargs.get("mix_bias", 0.6))
        self.replay_cpb = 4 if self.inc_cls_num == 5 else 2  # classes replayed per batch
        self.replay_per_cls = int(10 * self.beta)
        self.edge_per_pair = int(20 * self.beta)  # edge samples per hard pair
        # fixed capacity of the per-task hard-pair set
        self.hard_cap = int(self.kwargs.get("hard_pairs_cap", 32))

    def init_state(self, seed, sample_input_hw) -> TrainState:
        gen = make_generator(seed, "cpu")
        clip = self.build_clip(gen)
        d = clip.embed_dim
        # bias-free Linear(d, d) with torch's default init, U(+-1/sqrt(d)),
        # stored as the JAX package's (in, out) kernel
        bound = 1.0 / float(np.sqrt(d))
        kernel = torch.empty(d, d).uniform_(-bound, bound, generator=gen)
        return self.make_state(clip, kernel, seed)

    def make_state(self, clip: CLIP, kernel: torch.Tensor, seed: int) -> TrainState:
        """State around a frozen CLIP and an adapter kernel (in, out)."""
        dev, n, d = self.device, self.num_class, clip.embed_dim
        self.embed_dim = d
        clip = clip.to(dev).requires_grad_(False)
        params = nn.ModuleDict({
            "adapter": nn.ParameterDict({"kernel": nn.Parameter(kernel.to(dev, torch.float32))})
        })
        seen, prev = make_masks(n, 0, self.init_cls_num, dev)
        zeros_i = lambda m: torch.zeros(m, dtype=torch.int64, device=dev)  # noqa: E731
        mvars = {
            "frozen": clip,
            "text_feats": torch.zeros(n, d, device=dev),
            "cls_mean": torch.zeros(n, d, device=dev),
            # Cholesky factors of the per-class covariances; the identity until
            # a class is seen (never sampled before, and non-degenerate)
            "cls_chol": torch.eye(d, device=dev).expand(n, d, d).clone(),
            "cls_valid": torch.zeros(n, device=dev),
            "replay_order": zeros_i(n),  # round-robin order of the old classes
            "replay_len": 1,
            "hard_old": zeros_i(self.hard_cap),  # padded hard (old, new) pairs
            "hard_new": zeros_i(self.hard_cap),
            "hard_valid": torch.zeros(self.hard_cap, device=dev),
            "old_adapter": {"kernel": torch.zeros(d, d, device=dev)},
        }
        return TrainState(
            params=params,
            opt_state=self._tx_for_task(0, params.parameters()),
            mvars=mvars,
            rng=make_generator(seed, dev),
            step=0,
            task=0,
            seen_mask=seen,
            prev_mask=prev,
        )

    @torch.no_grad()
    def before_task(self, state, task_idx, task_data):
        """Text features of every class through the frozen tower; from task 1
        on, the shuffled replay order of the old classes and the hard pairs."""
        mv = state.mvars
        f, _ = mv["frozen"].encode_text(self.class_tokens(0, self.num_class))
        mv["text_feats"] = normalized(f, eps=1e-8)
        if task_idx > 0:
            n_old = self.init_cls_num + (task_idx - 1) * self.inc_cls_num
            rng = np.random.RandomState(int(self.config.get("seed", 0)) + task_idx)
            order = np.resize(rng.permutation(n_old), self.num_class)  # cycle-padded
            mv["replay_order"] = torch.from_numpy(order.astype(np.int64)).to(self.device)
            mv["replay_len"] = n_old
            # hard pairs: normalised text features closer than the threshold,
            # row-major over (old, new)
            tf = mv["text_feats"].cpu().numpy().astype(np.float32)
            n_new = min(self.inc_cls_num, self.num_class - n_old)
            diff = np.linalg.norm(
                tf[n_old:n_old + n_new][None, :, :] - tf[:n_old][:, None, :], axis=-1
            )
            ko, kn = np.nonzero(diff < self.threshold)
            if len(ko) > self.hard_cap:
                logging.getLogger("libcontinual_tpu_torch").warning(
                    "RAPF: %d hard pairs exceed hard_pairs_cap=%d; truncating",
                    len(ko), self.hard_cap,
                )
                ko, kn = ko[: self.hard_cap], kn[: self.hard_cap]
            hard = np.zeros((3, self.hard_cap), np.int64)
            hard[0, : len(ko)] = ko
            hard[1, : len(ko)] = n_old + kn
            hard[2, : len(ko)] = 1
            hard = torch.from_numpy(hard).to(self.device)
            mv["hard_old"], mv["hard_new"] = hard[0], hard[1]
            mv["hard_valid"] = hard[2].float()
        return state

    @torch.no_grad()
    def _image_feats(self, mvars, x):
        return mvars["frozen"].encode_image(x)[0]

    @staticmethod
    def _adapted(params, f):
        return normalized(f @ params["adapter"]["kernel"], eps=1e-8)

    def draw_noise(self, state: TrainState) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standard normals for one step: the replay draws (classes per
        batch, samples per class, d) and the edge draws (hard pairs, samples
        per pair, d)."""
        shapes = ((self.replay_cpb, self.replay_per_cls, self.embed_dim),
                  (self.hard_cap, self.edge_per_pair, self.embed_dim))
        return tuple(torch.randn(s, generator=state.rng, device=self.device) for s in shapes)

    def loss(self, state, batch, noise=None):
        """One CE over [current images; Gaussian-replayed old features] plus
        the hard-pair hinge over edge samples drawn from each pair's old
        class. ``noise`` is :meth:`draw_noise`'s pair, drawn here if absent."""
        mv = state.mvars
        f = self._image_feats(mv, batch["x"])
        replay_noise, edge_noise = self.draw_noise(state) if noise is None else noise
        tf = mv["text_feats"]
        scale = torch.exp(mv["frozen"].logit_scale)
        dev = f.device

        # a few round-robin old classes per batch, sampled through their
        # Cholesky factors; state.step carries the round-robin across epochs
        cpb, n_per, d = self.replay_cpb, self.replay_per_cls, self.embed_dim
        slot = state.step * cpb + torch.arange(cpb, device=dev)
        cls = mv["replay_order"][slot % max(mv["replay_len"], 1)]
        rf = mv["cls_mean"][cls][:, None, :] + torch.einsum(
            "cnd,ced->cne", replay_noise, mv["cls_chol"][cls])
        rf = rf.reshape(cpb * n_per, d)
        r_targets = cls.repeat_interleave(n_per)

        g_all = self._adapted(state.params, torch.cat([f, rf], dim=0))
        logits_all = scale * g_all @ tf.T
        targets_all = torch.cat([batch["label"].long(), r_targets])
        w_img = batch.get("weight")
        if w_img is None:
            w_img = torch.ones(f.shape[0], device=dev)
        replay_on = 1.0 if state.task > 0 else 0.0
        w_all = torch.cat([w_img, torch.full((rf.shape[0],), replay_on, device=dev)])
        ce = masked_cross_entropy(logits_all, targets_all, w_all, state.seen_mask)

        # hinge relu(-(e . t_old) + (e . t_new) + 0.1) on the edge samples
        P, ne = self.hard_cap, self.edge_per_pair
        ecls = mv["hard_old"]
        ef = mv["cls_mean"][ecls][:, None, :] + torch.einsum(
            "pnd,ped->pne", edge_noise, mv["cls_chol"][ecls])
        eg = self._adapted(state.params, ef.reshape(P * ne, d))
        t_old = tf[ecls.repeat_interleave(ne)]
        t_new = tf[mv["hard_new"].repeat_interleave(ne)]
        h = torch.relu(-(eg * t_old).sum(-1) + (eg * t_new).sum(-1) + 0.1)
        ev = mv["hard_valid"].repeat_interleave(ne)
        hinge = torch.sum(h * ev) / torch.clamp(ev.sum(), min=1.0)
        has_edge = (mv["hard_valid"].sum() > 0).float()
        loss = ce + has_edge * hinge
        logits = logits_all[: f.shape[0]]
        return loss, {"logits": torch.where(state.seen_mask[None, :] > 0, logits, -1e30)}

    @torch.no_grad()
    def after_task(self, state, task_idx, task_data):
        """Per-class means and Cholesky factors of the covariances (+ 1e-4 I)
        over the task's training images, as the train transform gives them;
        from task 1 on, the SVD fusion of the adapter with the previous one."""
        mv = state.mvars
        bs = int(self.config["batch_size"])
        mean = mv["cls_mean"].cpu().numpy().copy()
        chol = mv["cls_chol"].cpu().numpy().copy()
        valid = mv["cls_valid"].cpu().numpy().copy()
        feats_all, labels_all = [], []
        for im, lb, w in batch_iter(task_data.images, task_data.labels, bs, self.device):
            fl = self._image_feats(mv, self.augment(state.rng, im, train=True)).cpu().numpy()
            keep = w.cpu().numpy() > 0
            feats_all.append(fl[keep])
            labels_all.append(lb.cpu().numpy()[keep])
        feats = np.concatenate(feats_all).astype(np.float64)
        labels = np.concatenate(labels_all)
        d = feats.shape[1]
        for c in np.unique(labels):
            fc = feats[labels == c]
            mean[c] = fc.mean(0)
            cov = np.cov(fc.T) + 1e-4 * np.eye(d) if len(fc) > 1 else 1e-4 * np.eye(d)
            if self.shrinkage:
                cov = shrink_cov(cov)
            chol[c] = np.linalg.cholesky(cov).astype(np.float32)
            valid[c] = 1.0

        kernel = state.params["adapter"]["kernel"]
        if task_idx > 0:
            # torch's Linear weight (out, in) is the kernel transposed
            W_old = mv["old_adapter"]["kernel"].cpu().numpy().T
            W_new = kernel.detach().cpu().numpy().T
            fused = mix_matrix(W_old, W_new, self.mix_bias)
            kernel.copy_(torch.from_numpy(fused.T.astype(np.float32)))

        mv["cls_mean"] = torch.from_numpy(mean.astype(np.float32)).to(self.device)
        mv["cls_chol"] = torch.from_numpy(chol.astype(np.float32)).to(self.device)
        mv["cls_valid"] = torch.from_numpy(valid.astype(np.float32)).to(self.device)
        mv["old_adapter"] = copy_tree(state.params["adapter"])
        return state

    @torch.no_grad()
    def eval_logits(self, state, x, task_id):
        mv = state.mvars
        g = self._adapted(state.params, self._image_feats(mv, x))
        logits = torch.exp(mv["frozen"].logit_scale) * g @ mv["text_feats"].T
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)
