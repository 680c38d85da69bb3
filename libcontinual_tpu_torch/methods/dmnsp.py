"""DMNSP, Dual-Modality-guided Null-Space Projection, on the adapter ViT
(``libcontinual_tpu/methods/dmnsp.py``).

  * a frozen ViT with a bottleneck adapter beside each block's MLP; only the
    adapters (``params["adapters"]``, f32) and the head train;
  * CE over the current task's classes with DMNSP's own label smoothing
    (:func:`smoothed_ce`: ``s / n_valid`` on each valid class);
  * from task 1 on, each block's adapter gradients are projected onto the
    accumulated basis and scaled by the block's lambda: ``down`` (torch
    ``(b, d)``) gets ``g P^T * lam``, ``up`` (``(d, b)``) gets ``P^T g * lam``;
    the biases are not projected;
  * the protected stream is the adapter's output: each block's raw
    post-attention residual is captured over one seeded random batch and the
    adapter re-applied (:func:`adapter_outputs`); the covariance of those
    outputs drives both the basis and the lambdas (f32, as in the JAX
    package, in ``torch.linalg`` on the method's device);
  * after each task, the covariance's singular vectors minus the dominant one
    extend the basis (re-orthonormalised, :func:`nsp_extend_basis`); before
    each task after the first, ``lam = exp(-mean(top 10% |cos|)) *
    lamda_scale`` between the new dominant direction and the stored basis
    (:func:`nsp_lambda`).

The ViT's trunk is stored in the compute dtype without gradients in
``mvars["frozen"]``; its blocks hold the adapters, which ``params`` shares.
"""

from __future__ import annotations

import math
import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.core.method import Method
from libcontinual_tpu_torch.core.state import TrainState, make_masks
from libcontinual_tpu_torch.methods.common import svd
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


def nsp_lambda(basis: torch.Tensor, counts: List[int], covs: List[torch.Tensor],
               scale: float) -> torch.Tensor:
    """Per block, ``exp(-mean of the top 10% |cos|) * scale`` between the
    covariance's dominant direction and the stored basis columns (1 where
    the basis is empty)."""
    lam = torch.ones(len(covs), device=basis.device)
    for j, cov in enumerate(covs):
        n = int(counts[j])
        if n == 0:
            continue
        top = svd(cov)[0][:, 0]
        sims = torch.abs(basis[j][:, :n].T @ top)
        k = max(1, int(n * 0.1))
        lam[j] = math.exp(-float(torch.sort(sims, descending=True)[0][:k].mean())) * scale
    return lam


def nsp_extend_basis(basis: torch.Tensor, counts: List[int], covs: List[torch.Tensor]):
    """Each block's basis extended by its covariance's singular vectors minus
    the dominant one, re-orthonormalised by QR (columns whose ``|r_ii|`` is
    at most 1e-6 dropped). Returns (basis, counts, P = B B^T)."""
    basis = basis.clone()
    d = basis.shape[1]
    new_counts = []
    P = torch.zeros_like(basis)
    for i, cov in enumerate(covs):
        v = svd(cov)[0][:, 1:]
        n = int(counts[i])
        q, r = torch.linalg.qr(torch.cat([basis[i][:, :n], v], dim=1))
        q = q[:, torch.abs(torch.diagonal(r)) > 1e-6][:, :d]
        m = q.shape[1]
        basis[i].zero_()
        basis[i][:, :m] = q
        new_counts.append(m)
        P[i] = q @ q.T
    return basis, new_counts, P


def adapter_outputs(streams: List[torch.Tensor], adapters: nn.ModuleDict,
                    scale: float) -> List[torch.Tensor]:
    """Each block's adapter re-applied (f32, no dropout) to its captured
    input stream: the adapter's scaled output."""
    outs = []
    for i, a in enumerate(streams):
        ad = adapters[f"block_{i}"]
        h = torch.relu(F.linear(a, ad.down.weight, ad.down.bias))
        outs.append(F.linear(h, ad.up.weight, ad.up.bias) * scale)
    return outs


def smoothed_ce(logits, labels, weight, class_mask, smoothing: float):
    """CE over the classes of ``class_mask`` with ``1 - s`` on the label and
    ``s / n_valid`` on every valid class."""
    n_valid = torch.clamp(class_mask.sum(), min=1.0)
    logits = torch.where(class_mask[None, :] > 0, logits, -1e30)
    ll = F.log_softmax(logits, dim=-1)
    # a scatter, not F.one_hot: its range check would wait for the device
    target = torch.zeros_like(ll).scatter(-1, labels.long()[:, None], 1.0 - smoothing)
    target = target + smoothing / n_valid * class_mask[None, :]
    nll = -torch.sum(target * ll * class_mask[None, :], dim=-1)
    if weight is None:
        return nll.mean()
    return torch.sum(nll * weight) / torch.clamp(weight.sum(), min=1.0)


@METHODS.register("DMNSP")
class DMNSP(Method):
    concat_buffer = False

    def __init__(self, config, device):
        # the backbone carries adapters; the reference's CLIP-style blocks
        # use torch's default LayerNorm eps
        bk = config["backbone"].get("kwargs")
        if bk is None:
            bk = config["backbone"]["kwargs"] = {}
        bk.setdefault("adapter_dim", bk.get("ffn_num", 64))
        bk.setdefault("block_ln_eps", 1e-5)
        super().__init__(config, device)
        self.label_smoothing = float(self.kwargs.get("label_smoothing", 0.0))
        self.lamda_scale = float(self.kwargs.get("lamda_scale", 30.0))
        self.embed_dim = int(self.kwargs.get("embd_dim", self.kwargs.get("feat_dim", 768)))

    def init_state(self, seed, sample_input_hw) -> TrainState:
        path = ((self.config.get("backbone") or {}).get("kwargs") or {}).get("pretrained_path")
        if path and os.path.exists(os.path.expanduser(path)):
            raise NotImplementedError(
                f"pretrained_path {path!r}: loading timm weights is not in the PyTorch port yet"
            )
        gen = make_generator(seed, "cpu")
        vit = get_backbone(self.config, gen)
        head = LinearHead(self.embed_dim, self.num_class, generator=gen)
        return self.make_state(vit, head, seed)

    def make_state(self, vit: nn.Module, head: nn.Module, seed: int) -> TrainState:
        """State around given modules: the trunk frozen in the compute dtype,
        the adapters and the head trainable in f32."""
        if vit.adapter_dim <= 0:
            raise ValueError("DMNSP needs a ViT with adapters (adapter_dim > 0)")
        vit = vit.to(self.device)
        with torch.no_grad():
            for name, p in vit.named_parameters():
                adapter = ".adaptmlp." in name
                if not adapter:
                    p.data = p.data.to(self.dtype)
                p.requires_grad_(adapter)
        adapters = nn.ModuleDict({f"block_{i}": blk.adaptmlp for i, blk in enumerate(vit.blocks)})
        params = nn.ModuleDict({"head": head, "adapters": adapters}).to(self.device)
        depth, d = len(vit.blocks), self.embed_dim
        seen, prev = make_masks(self.num_class, 0, self.init_cls_num, self.device)
        mvars = {
            "frozen": vit.eval(),
            # orthonormal basis columns (zero-padded), their count, P = B B^T
            "basis": torch.zeros(depth, d, d, device=self.device),
            "basis_n": [0] * depth,
            "P": torch.zeros(depth, d, d, device=self.device),
            "lam": torch.ones(depth, device=self.device),
            "proj_on": False,
        }
        return TrainState(params=params, opt_state=self._tx_for_task(0, params.parameters()),
                          mvars=mvars, rng=make_generator(seed, self.device), step=0, task=0,
                          seen_mask=seen, prev_mask=prev)

    # ------------------------------------------------------------------ step

    def draw(self, state, batch):
        """The step's random numbers: each block's adapter dropout keep mask."""
        vit = state.mvars["frozen"]
        shape = (batch["label"].shape[0], vit.pos_embed.shape[1], vit.adapter_dim)
        keep = [torch.rand(shape, generator=state.rng, device=self.device)
                < 1.0 - blk.adaptmlp.dropout_rate for blk in vit.blocks]
        return {"adapter_keep": keep}

    def loss(self, state, batch):
        d = self.draw(state, batch)
        feats = state.mvars["frozen"](batch["x"], adapter_keep=d["adapter_keep"])["features"]
        logits = state.params["head"](feats)
        cur = state.seen_mask - state.prev_mask
        ce = smoothed_ce(logits, batch["label"], batch.get("weight"), cur, self.label_smoothing)
        return ce, {"logits": torch.where(cur[None, :] > 0, logits, -1e30)}

    @torch.no_grad()
    def transform_grads(self, state):
        mv = state.mvars
        if not mv["proj_on"]:
            return
        for i, ad in enumerate(state.params["adapters"].values()):
            P, lam = mv["P"][i], mv["lam"][i]
            if ad.down.weight.grad is not None:
                ad.down.weight.grad.copy_((ad.down.weight.grad @ P.T) * lam)
            if ad.up.weight.grad is not None:
                ad.up.weight.grad.copy_((P.T @ ad.up.weight.grad) * lam)

    def eval_logits(self, state, x, task_id):
        logits = state.params["head"](state.mvars["frozen"](x)["features"])
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)

    # ----------------------------------------------------------------- hooks

    @torch.no_grad()
    def block_covs(self, state, task_data) -> List[torch.Tensor]:
        """Each block's ``(d, d)`` f32 covariance of the adapter's outputs over
        one seeded random batch (task data is class-ordered: its first rows
        would be one class)."""
        bs = min(int(self.config["batch_size"]), len(task_data))
        idx = np.random.RandomState(int(self.config.get("seed", 0))).permutation(len(task_data))
        images = torch.from_numpy(np.ascontiguousarray(task_data.images[idx[:bs]]))
        x = self.augment(None, images.to(self.device), train=False)
        vit = state.mvars["frozen"]
        streams = vit(x, capture=True, capture_point="mlp")["attn_inputs"]
        outs = adapter_outputs(streams, state.params["adapters"], vit.adapter_scale)
        return [o.reshape(-1, o.shape[-1]).T @ o.reshape(-1, o.shape[-1]) for o in outs]

    def before_task(self, state, task_idx, task_data):
        if task_idx > 0:
            mv = state.mvars
            mv["lam"] = nsp_lambda(mv["basis"], mv["basis_n"], self.block_covs(state, task_data),
                                   self.lamda_scale)
            mv["proj_on"] = True
        return state

    def after_task(self, state, task_idx, task_data):
        mv = state.mvars
        mv["basis"], mv["basis_n"], mv["P"] = nsp_extend_basis(
            mv["basis"], mv["basis_n"], self.block_covs(state, task_data))
        return state
