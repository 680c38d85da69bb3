"""OCM, online continual learning through mutual information maximisation
(Guo et al., ICML 2022) (``libcontinual_tpu/methods/ocm.py``).

  * a 16x rotation expansion of each batch: 4 inner half-image rotations
    times 4 global rot90s, the labels offset by ``1000 * k`` so that each
    rotation is its own class for the contrastive loss;
  * a SimCLR pipeline (RandomResizedCrop at scale 0.6-1.0, flip, ColorJitter
    0.4, RandomGrayscale 0.2) on the expanded batch, from ``state.rng``;
  * supervised NT-Xent over ``[rotations; augmented rotations]``, a random
    slice of the normalised features added into the similarity matrix;
  * task 0: CE on the SimCLR-augmented batch plus the NT-Xent; later tasks:
    replay from the reservoir slab (``methods/er.py``, filled after each
    optimizer step), the replay CE, the NT-Xent of the incoming and the
    replayed rotations (one forward over ``[pair; pair_r]``, so the two share
    the batch's statistics), the NT-Xent of the replay against the frozen
    model of the previous task (``teacher``, in train mode on the batch's
    statistics unless ``teacher_batch_stats: false``) and the MSE of the old
    classes' logits against it;
  * one forward a step moves the running statistics: the CE's at task 0,
    ``[pair; pair_r]``'s after; the others run with ``update_stats=False``;
  * the images reach the loss as ``[0, 1]`` floats (``augment`` is the
    identity over 255, for training and evaluation alike); evaluation masks
    the classes not seen yet.

A step's draws besides the SimCLR pipeline's come from :meth:`OCM.draw`, so a
test can feed the JAX package's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.data.transforms import Pipeline
from libcontinual_tpu_torch.methods.common import masked_eval_logits, snapshot
from libcontinual_tpu_torch.methods.er import (batch_weight, new_buffer, replay_indices,
                                               reservoir_add, reservoir_slots, sample_random)
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


def rot_inner_all(x: torch.Tensor) -> torch.Tensor:
    """The 4 half-image inner rotations of an NHWC batch (square, even H):
    the original, the first half turned by 180 degrees, both, the second;
    ``(4n, H, W, C)``."""
    n, h, w, c = x.shape
    a = x.transpose(1, 2).reshape(n, 2, h // 2, w, c)
    s1, s2 = a[:, 0], a[:, 1]

    def rot2(z):
        return torch.rot90(z, 2, dims=(1, 2))

    outs = [torch.stack([top, bot], dim=1).reshape(n, h, w, c).transpose(1, 2)
            for top, bot in ((s1, s2), (rot2(s1), s2), (rot2(s1), rot2(s2)), (s1, rot2(s2)))]
    return torch.cat(outs)


def rotation_expand(x: torch.Tensor, y: torch.Tensor):
    """The 16x expansion (the 4 inner rotations, each turned by 0-3 rot90s
    over the NHWC dims) and its labels ``y + 1000 * k``."""
    n = x.shape[0]
    rots = rot_inner_all(x)
    x16 = torch.cat([rots] + [torch.rot90(rots, k, dims=(1, 2)) for k in (1, 2, 3)])
    offsets = torch.repeat_interleave(torch.arange(16, device=y.device) * 1000, n)
    return x16, y.repeat(16) + offsets


def _nt_logm(sim: torch.Tensor, temperature: float, exclude_diag: bool) -> torch.Tensor:
    """The -log softmax-similarity matrix of every NT-Xent variant."""
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()
    e = torch.exp(sim / temperature)
    if exclude_diag:
        e = e * (1 - torch.eye(sim.shape[0], device=sim.device))
    denom = e.sum(dim=1, keepdim=True)
    return -torch.log(e / (denom + 1e-8) + 1e-8)


def _label_mask(labels: torch.Tensor) -> torch.Tensor:
    mask = (labels[:, None] == labels[None, :]).float()
    return mask / (mask.sum(dim=1, keepdim=True) + 1e-8)


def nt_xent(sim: torch.Tensor, labels: torch.Tensor, temperature: float = 0.07,
            mode: str = "n") -> torch.Tensor:
    """Supervised NT-Xent over a ``(2b, 2b)`` similarity matrix; ``labels``
    has b entries (the augmented half repeats them). ``n``: the diagonal
    excluded, the label-mask sum doubled plus the augmented pairs' positive
    diagonals; ``uni``: the diagonal kept, the label-mask sum alone."""
    b = sim.shape[0] // 2
    mask = _label_mask(torch.cat([labels, labels]))
    if mode == "uni":
        return torch.sum(mask * _nt_logm(sim, temperature, exclude_diag=False)) / (2 * b)
    logm = _nt_logm(sim, temperature, exclude_diag=True)
    loss1 = 2 * torch.sum(mask * logm) / (2 * b)
    pos = torch.sum(torch.diagonal(logm[:b, b:]) + torch.diagonal(logm[b:, :b])) / (2 * b)
    return pos + loss1


def nt_xent_pre(sim: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07) -> torch.Tensor:
    """The NT-Xent against the previous model: ``uni``'s, with one label per
    row."""
    b = sim.shape[0] // 2
    logm = _nt_logm(sim, temperature, exclude_diag=False)
    return torch.sum(_label_mask(labels) * logm) / (2 * b)


def _norm(z: torch.Tensor) -> torch.Tensor:
    return z / (torch.linalg.vector_norm(z, dim=1, keepdim=True) + 1e-8)


@METHODS.register("OCM")
class OCM(Method):
    concat_buffer = False

    def __init__(self, config, device):
        super().__init__(config, device)
        buf_kwargs = (config.get("buffer") or {}).get("kwargs") or {}
        self.capacity = int(buf_kwargs.get("buffer_size", 1000))
        self.buffer_batch_cap = int(self.kwargs.get("buffer_batch_size", 64))
        # the replay batch is min(64, 7 x the classes seen)
        self.buffer_per_class = int(self.kwargs.get("buffer_per_class", 7))
        self.proj_dim = min(128, int(self.kwargs.get("feat_dim", 512)) // 2 or 128)
        img = int(config.get("image_size", 32))
        self.simclr_aug = Pipeline([
            ("RandomResizedCrop", {"size": img, "scale": (0.6, 1.0)}),
            ("RandomHorizontalFlip", {}),
            ("ColorJitter", {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4}),
            ("RandomGrayscale", {"p": 0.2}),
        ])

    def init_state(self, seed, sample_input_hw):
        """The backbone, the linear head and the projection ``proj``
        (weights N(0, 0.02^2), bias 0)."""
        gen = make_generator(seed, "cpu")
        backbone = get_backbone(self.config, gen)
        head = LinearHead(self.feat_dim, self.num_class, generator=gen)
        proj = nn.Linear(self.feat_dim, self.proj_dim)
        with torch.no_grad():
            proj.weight.normal_(0.0, 0.02, generator=gen)
            proj.bias.zero_()
        return self.backbone_state(backbone, head, seed, proj=proj)

    def init_mvars(self, state):
        size = int(self.config.get("image_size", 32))
        return {"buffer": new_buffer(self.capacity, size, self.device),
                "teacher": snapshot(state.params)}

    def augment(self, gen, images, train=True):
        return images.float() / 255.0

    def buffer_batch(self, task: int) -> int:
        """The replay batch of task ``task``: min(``buffer_batch_size``,
        ``buffer_per_class`` x the classes seen)."""
        seen = self.init_cls_num + self.inc_cls_num * task
        return max(1, min(self.buffer_batch_cap, self.buffer_per_class * seen))

    def after_task(self, state, task_idx, task_data):
        state.mvars["teacher"] = snapshot(state.params)
        return state

    def draw(self, state, batch) -> Dict[str, torch.Tensor]:
        """A step's numbers besides the SimCLR pipeline's, from
        ``state.rng``: the two feature-slice offsets (``slice``, the second
        one used from task 1 on), the replay indices from task 1 on
        (``replay_idx``) and the reservoir's ``slots``."""
        gen, buf = state.rng, state.mvars["buffer"]
        hi = max(self.feat_dim - self.proj_dim, 1)
        d = {"slice": torch.randint(0, hi, (2,), generator=gen, device=self.device)}
        if state.task > 0:
            d["replay_idx"] = replay_indices(buf, self.buffer_batch(state.task), gen)
        d["slots"] = reservoir_slots(buf, batch_weight(batch), gen)
        return d

    def post_update(self, state, batch, aux):
        reservoir_add(state.mvars["buffer"], batch["image"], batch["label"],
                      torch.full_like(batch["label"], state.task), batch_weight(batch),
                      aux["draws"]["slots"])
        return state

    # ------------------------------------------------------------------ loss

    def _embed(self, params, x, train=True, update_stats=True):
        f = self.apply_backbone(params, x, train, update_stats)["features"]
        return f, params["proj"](f)

    def _slice(self, fmap, start):
        """``proj_dim`` feature columns from ``start`` (a device scalar)."""
        return fmap.index_select(1, start + torch.arange(self.proj_dim, device=fmap.device))

    def _similarity(self, proj, f, start):
        simclr = _norm(proj)
        return simclr @ self._slice(_norm(f), start).T + simclr @ simclr.T, simclr

    def loss(self, state, batch):
        d = self.draw(state, batch)
        if state.task > 0:
            loss, logits = self._loss_incremental(state, batch, d)
        else:
            loss, logits = self._loss_first(state, batch, d)
        return loss, {"logits": logits, "draws": d}

    def _loss_first(self, state, batch, d):
        """CE on the SimCLR-augmented batch (the full head) plus the NT-Xent
        of the rotation pair, whose forward leaves the running statistics
        alone."""
        x, y = batch["image"].float() / 255.0, batch["label"]
        logits, _ = self.forward(state.params, self.simclr_aug(state.rng, x), train=True)
        ce = masked_cross_entropy(logits, y, batch.get("weight"))
        xr, yr = rotation_expand(x, y)
        pair = torch.cat([xr, self.simclr_aug(state.rng, xr)])
        f, proj = self._embed(state.params, pair, update_stats=False)
        sim, _ = self._similarity(proj, f, d["slice"][0])
        return ce + nt_xent(sim, yr, 0.07, "n"), logits

    def _loss_incremental(self, state, batch, d):
        """Replay CE, the NT-Xent of the incoming (``n``) and replayed
        (``uni``) rotation pairs, the replay's NT-Xent against the teacher
        and the MSE of the old classes' logits against it; the incoming
        batch's weight plays no part."""
        params, teacher, aug = state.params, state.mvars["teacher"], self.simclr_aug
        mx, my, mw = sample_random(state.mvars["buffer"], d["replay_idx"])
        xr, yr = rotation_expand(batch["image"].float() / 255.0, batch["label"])
        xr_r, yr_r = rotation_expand(mx.float() / 255.0, my)
        pair = torch.cat([xr, aug(state.rng, xr)])
        pair_r = torch.cat([xr_r, aug(state.rng, xr_r)])
        n = pair.shape[0]
        f, proj = self._embed(params, torch.cat([pair, pair_r]))
        sim, _ = self._similarity(proj[:n], f[:n], d["slice"][0])
        sim_r, simclr_r = self._similarity(proj[n:], f[n:], d["slice"][1])
        c_inc = nt_xent(sim, yr, 0.07, "n")
        c_rep = nt_xent(sim_r, yr_r, 0.07, "uni")
        with torch.no_grad():
            _, t_proj = self._embed(teacher, xr_r, train=self.teacher_train, update_stats=False)
        c_pre = nt_xent_pre(simclr_r[: xr_r.shape[0]] @ _norm(t_proj).T, yr_r, 0.07)

        mem_aug = aug(state.rng, mx.float() / 255.0)
        m_logits, _ = self.forward(params, mem_aug, train=True, update_stats=False)
        ce_mem = masked_cross_entropy(m_logits, my, mw)
        with torch.no_grad():
            t_logits, _ = self.forward(teacher, mem_aug, train=self.teacher_train,
                                       update_stats=False)
            # the metric's logits: the raw incoming batch
            logits, _ = self.forward(params, batch["image"].float() / 255.0, train=True,
                                     update_stats=False)
        # the MSE over the old classes' columns only
        sq = ((m_logits - t_logits) * state.prev_mask[None, :]) ** 2
        mse = sq.sum() / (m_logits.shape[0] * torch.clamp(state.prev_mask.sum(), min=1.0))
        return ce_mem + c_inc + c_rep + c_pre + mse, logits

    def eval_logits(self, state, x, task_id):
        return masked_eval_logits(self, state, x)
