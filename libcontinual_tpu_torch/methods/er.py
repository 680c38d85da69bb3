"""ER-ACE and ER-AML, online continual learning with experience replay
(Caccia et al., ICLR 2022) (``libcontinual_tpu/methods/er.py``).

  * the replay buffer is device tensors in ``mvars["buffer"]``: ``bx``, a
    uint8 ``(cap, H, W, 3)`` NHWC image slab, int64 labels ``by`` and tasks
    ``bt``, and ``n_seen``, a 0-d int64 count of the weight-1 images seen;
  * each buffer function is split into its draws and a deterministic
    function of them, so a test can feed the JAX package's draws:
    :func:`reservoir_slots` and :func:`reservoir_add`, :func:`gumbel` and
    :func:`balanced_add`, :func:`replay_indices` and :func:`sample_random`,
    :func:`gumbel` and :func:`sample_balanced`. A method draws a whole step's
    numbers from ``state.rng`` in one call, :meth:`_ERBase.draw`;
  * nothing waits on the host inside a step: the reservoir add is
    vectorised over the batch, and the class-balanced add loops over the
    batch with every choice made on the device;
  * the buffer is filled after the optimizer step (``post_update``) and never
    goes through the trainer's buffer (``concat_buffer = False``);
  * ER-ACE: CE on the incoming batch masked to the classes not seen before
    this task, plus plain CE on 10 replayed images (from task 0 on with
    ``task_free``); ER-AML: SupCon of the incoming features against a
    positive (same class) and a negative (same task, another class) mined
    from the buffer by Gumbel-argmax, plus the replay CE;
  * the ``DistLinear`` cosine head, evaluated on all its classes;
  * one forward a step moves the running statistics, the incoming batch's:
    the replay and ``[pos; neg]`` forwards run with ``update_stats=False``,
    as the JAX package keeps only the incoming batch's ``model_state``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import DistLinear
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator

Buffer = Dict[str, torch.Tensor]


def new_buffer(capacity: int, image_size: int, device) -> Buffer:
    """An empty slab buffer of ``capacity`` images of ``image_size`` px."""
    return {
        "bx": torch.zeros((capacity, image_size, image_size, 3), dtype=torch.uint8,
                          device=device),
        "by": torch.zeros(capacity, dtype=torch.int64, device=device),
        "bt": torch.zeros(capacity, dtype=torch.int64, device=device),
        "n_seen": torch.zeros((), dtype=torch.int64, device=device),
    }


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in (0, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _seen_before(n_seen: torch.Tensor, weight: torch.Tensor):
    """(n_i, valid): the weight-1 images seen before item i of the batch, and
    which items weigh 1."""
    valid = (weight > 0).long()
    return n_seen + torch.cumsum(valid, 0) - valid, valid > 0


def reservoir_slots(buf: Buffer, weight: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """The draws of :func:`reservoir_add`: for item i a slot uniform in
    ``[0, n_i]``."""
    n, _ = _seen_before(buf["n_seen"], weight)
    u = torch.rand(weight.shape, generator=gen, device=weight.device)
    return torch.minimum((u.double() * (n + 1)).long(), n)


def _write_rows(buf: Buffer, dst, take, src, images, labels, tasks) -> None:
    """Slot ``dst[i]`` gets item ``src[i]`` where ``take[i]``, else keeps its
    row; every write to one slot must carry the same row."""
    for key, new in (("bx", images), ("by", labels), ("bt", tasks)):
        old = buf[key][dst]
        mask = take.view(-1, *([1] * (old.dim() - 1)))
        buf[key].index_put_((dst,), torch.where(mask, new[src].to(old.dtype), old))


def reservoir_add(buf: Buffer, images, labels, tasks, weight, slots) -> Buffer:
    """Reservoir sampling of one batch, in place, given :func:`reservoir_slots`'
    ``slots``: weight-1 item i, with n_i weight-1 images seen before it,
    goes to slot n_i while the buffer has room, else to ``slots[i]`` when
    that is below the capacity. Weight-0 items (the trainer's padding)
    neither add nor count. Where two items land on one slot the later one
    stays, as in the JAX package's sequential loop: each slot's last writer
    is found with a ``scatter_reduce(amax)`` of the item index, and every
    write to the slot carries that item's row."""
    cap = buf["by"].shape[0]
    n, valid = _seen_before(buf["n_seen"], weight)
    place = torch.where(n < cap, n, slots)
    add = valid & (place < cap)
    item = torch.arange(weight.shape[0], device=weight.device)
    last = torch.full((cap + 1,), -1, dtype=torch.int64, device=weight.device).scatter_reduce_(
        0, torch.where(add, place, cap), item, "amax")  # slot cap: the items that add nothing
    dst = torch.where(add, place, 0)
    win = last[dst]
    _write_rows(buf, dst, win >= 0, win.clamp(min=0), images, labels, tasks)
    buf["n_seen"] += valid.sum()
    return buf


def balanced_add(buf: Buffer, images, labels, tasks, weight, noise, num_class: int) -> Buffer:
    """Class-balanced insertion, in place, given ``noise``: a ``(B, cap)``
    Gumbel draw. While the buffer has room item i goes to slot ``n_seen``;
    once it is full, to the slot of the current majority class with the
    largest noise. Each choice depends on the previous insert, so this loops
    over the batch, on the device."""
    cap = buf["by"].shape[0]
    slot = torch.arange(cap, device=weight.device)
    for i in range(weight.shape[0]):
        n_seen = buf["n_seen"]
        slot_valid = slot < n_seen
        counts = (F.one_hot(buf["by"], num_class).float() * slot_valid[:, None]).sum(0)
        is_major = (buf["by"] == counts.argmax()) & slot_valid
        evict = (torch.log(is_major.float() + 1e-30) + noise[i]).argmax()
        dst = torch.where(n_seen < cap, n_seen, evict).clamp(max=cap - 1).view(1)
        add = (weight[i] > 0).view(1)
        _write_rows(buf, dst, add, torch.full_like(dst, i), images, labels, tasks)
        buf["n_seen"] += add[0].long()
    return buf


def replay_indices(buf: Buffer, amt: int, gen: torch.Generator) -> torch.Tensor:
    """The draws of :func:`sample_random`: ``amt`` slots uniform over the
    filled ones (slot 0 while the buffer is empty)."""
    n = buf["n_seen"].clamp(min=1, max=buf["by"].shape[0])
    u = torch.rand(amt, generator=gen, device=n.device)
    return torch.minimum((u.double() * n).long(), n - 1)


def sample_random(buf: Buffer, idx: torch.Tensor):
    """(images, labels, weights) of slots ``idx``; replay row r weighs 1 when
    the buffer holds more than r images."""
    n = buf["n_seen"].clamp(max=buf["by"].shape[0])
    w = (torch.arange(idx.shape[0], device=idx.device) < n).float()
    return buf["bx"][idx], buf["by"][idx], w


def sample_balanced(buf: Buffer, class_noise, slot_noise, num_class: int):
    """Class-balanced sampling given two Gumbel draws, ``(amt, num_class)``
    and ``(amt, cap)``: a class uniform over those present, then one of its
    slots."""
    cap = buf["by"].shape[0]
    valid = (torch.arange(cap, device=class_noise.device) < buf["n_seen"]).float()
    present = (F.one_hot(buf["by"], num_class).float() * valid[:, None]).sum(0) > 0
    cls = (torch.log(present.float()[None] + 1e-30) + class_noise).argmax(1)
    match = (buf["by"][None, :] == cls[:, None]).float() * valid[None, :]
    idx = (torch.log(match + 1e-30) + slot_noise).argmax(1)
    w = (match.max(1).values > 0).float()
    return buf["bx"][idx], buf["by"][idx], w


def batch_weight(batch) -> torch.Tensor:
    w = batch.get("weight")
    return torch.ones(batch["label"].shape, device=batch["label"].device) if w is None else w


class _ERBase(Method):
    concat_buffer = False

    def __init__(self, config, device):
        super().__init__(config, device)
        buf_kwargs = (config.get("buffer") or {}).get("kwargs") or {}
        self.capacity = int(buf_kwargs.get("buffer_size", 1000))
        self.replay_amt = 10
        self.use_augs = bool(self.kwargs.get("use_augs", False))
        # with task_free the masked losses and the replay engage from task 0
        self.task_free = bool(self.kwargs.get("task_free", False))
        # "reservoir" (default) or "balanced" insertion; balanced sampling
        self.buffer_add = str(buf_kwargs.get("strategy", "reservoir"))
        self.balanced_sampling = bool(buf_kwargs.get("balanced_sampling", False))

    def init_state(self, seed, sample_input_hw):
        gen = make_generator(seed, "cpu")
        backbone = get_backbone(self.config, gen)
        head = DistLinear(self.feat_dim, self.num_class, generator=gen)
        return self.backbone_state(backbone, head, seed)

    def init_mvars(self, state):
        size = int(self.config.get("image_size", 32))
        return {"buffer": new_buffer(self.capacity, size, self.device), "seen_so_far": 0}

    def augment(self, gen, images, train=True):
        # without use_augs training runs on the test transform
        if train and not self.use_augs:
            return self.test_pipeline(None, images)
        return super().augment(gen, images, train)

    def draw(self, state, batch) -> Dict[str, torch.Tensor]:
        """Every random number of one train step, from ``state.rng``: the
        replay draws (``replay_idx``, or the balanced sampler's
        ``replay_class_noise`` and ``replay_slot_noise``) and the insertion's
        (``slots``, or the balanced add's ``evict_noise``)."""
        gen, buf, dev = state.rng, state.mvars["buffer"], self.device
        d = {}
        if self.balanced_sampling:
            d["replay_class_noise"] = gumbel(gen, (self.replay_amt, self.num_class), dev)
            d["replay_slot_noise"] = gumbel(gen, (self.replay_amt, self.capacity), dev)
        else:
            d["replay_idx"] = replay_indices(buf, self.replay_amt, gen)
        if self.buffer_add == "balanced":
            d["evict_noise"] = gumbel(gen, (batch["label"].shape[0], self.capacity), dev)
        else:
            d["slots"] = reservoir_slots(buf, batch_weight(batch), gen)
        return d

    def sample_replay(self, buf, d):
        if self.balanced_sampling:
            return sample_balanced(buf, d["replay_class_noise"], d["replay_slot_noise"],
                                   self.num_class)
        return sample_random(buf, d["replay_idx"])

    def replay_ce(self, state, d):
        """CE of the replayed images on the full head, 0 while the buffer is
        empty; their forward leaves the running statistics alone."""
        buf = state.mvars["buffer"]
        rx, ry, rw = self.sample_replay(buf, d)
        r_logits, _ = self.forward(state.params, self.augment(state.rng, rx), train=True,
                                   update_stats=False)
        return (buf["n_seen"] > 0).float() * masked_cross_entropy(r_logits, ry, rw)

    def after_task(self, state, task_idx, task_data):
        state.mvars["seen_so_far"] = self.init_cls_num + self.inc_cls_num * task_idx
        return state

    def post_update(self, state, batch, aux):
        buf, d = state.mvars["buffer"], aux["draws"]
        args = (buf, batch["image"], batch["label"], torch.full_like(batch["label"], state.task),
                batch_weight(batch))
        if self.buffer_add == "balanced":
            balanced_add(*args, d["evict_noise"], self.num_class)
        else:
            reservoir_add(*args, d["slots"])
        return state


@METHODS.register("ERACE")
class ERACE(_ERBase):
    def loss(self, state, batch):
        d = self.draw(state, batch)
        logits, _ = self.forward(state.params, batch["x"], train=True)
        # the incoming batch's CE sees only the classes from this task on
        cls = torch.arange(self.num_class, device=self.device)
        new_mask = (cls >= state.mvars["seen_so_far"]).float()
        loss = masked_cross_entropy(logits, batch["label"], batch.get("weight"), new_mask)
        if state.task > 0 or self.task_free:
            loss = loss + self.replay_ce(state, d)
        return loss, {"logits": logits, "draws": d}


@METHODS.register("ERAML")
class ERAML(_ERBase):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.temperature = float(self.kwargs.get("supcon_temperature", 0.1))
        self.use_minimal = bool(self.kwargs.get("use_minimal_selection", False))

    def draw(self, state, batch):
        """:meth:`_ERBase.draw`'s numbers and the mining noise: ``(B, cap)``
        Gumbel draws ``pos_noise`` and ``neg_noise`` and, with
        ``use_minimal_selection``, ``(B, B)`` ones ``min_pos_noise`` and
        ``min_neg_noise``."""
        d = super().draw(state, batch)
        b, gen = batch["label"].shape[0], state.rng
        for key in ("pos_noise", "neg_noise"):
            d[key] = gumbel(gen, (b, self.capacity), self.device)
        if self.use_minimal:
            for key in ("min_pos_noise", "min_neg_noise"):
                d[key] = gumbel(gen, (b, b), self.device)
        return d

    def _mine(self, buf, labels, task: int, pos_noise, neg_noise):
        """A positive from the buffer (same class) and a negative (same task,
        another class) for each item, by Gumbel-argmax over the candidates;
        ``ok`` where both exist."""
        cap = buf["by"].shape[0]
        valid = (torch.arange(cap, device=labels.device) < buf["n_seen"]).float()
        same_class = (buf["by"][None, :] == labels[:, None]).float() * valid
        pos_idx = (torch.log(same_class + 1e-30) + pos_noise).argmax(1)
        diff_class = (buf["by"][None, :] != labels[:, None]).float() * valid
        neg_mask = diff_class * (buf["bt"][None, :] == task).float()
        neg_idx = (torch.log(neg_mask + 1e-30) + neg_noise).argmax(1)
        ok = (same_class.max(1).values > 0) & (neg_mask.max(1).values > 0)
        return pos_idx, neg_idx, ok.float()

    def _mine_minimal(self, images, labels, weight, pos_noise, neg_noise):
        """A positive and a negative from the incoming batch itself (every
        candidate is of the current task: the batch holds no replay)."""
        b = labels.shape[0]
        valid = (weight > 0)[None, :]
        not_self = ~torch.eye(b, dtype=torch.bool, device=labels.device)
        same = (labels[:, None] == labels[None, :]) & not_self & valid
        diff = (labels[:, None] != labels[None, :]) & valid
        pos_idx = (torch.log(same.float() + 1e-30) + pos_noise).argmax(1)
        neg_idx = (torch.log(diff.float() + 1e-30) + neg_noise).argmax(1)
        ok = (same.any(1) & diff.any(1)).float()
        return images[pos_idx], labels[pos_idx], images[neg_idx], labels[neg_idx], ok

    def _supcon(self, feats, pos_h, neg_h, labels, pos_y, neg_y, ok):
        """SupCon of each anchor against the {pos, neg} contrast set, at
        ``temperature``, scaled by ``temperature / 0.07``; pairs without a
        valid positive and negative weigh 0."""
        def norm(z):
            return z / (torch.linalg.vector_norm(z, dim=1, keepdim=True) + 1e-5)

        contrast = torch.cat([norm(pos_h), norm(neg_h)])
        contrast_y = torch.cat([pos_y, neg_y])
        anchor = norm(feats)
        anchors, anchor_y = torch.cat([anchor, anchor]), torch.cat([labels, labels])
        ok2 = torch.cat([ok, ok])
        sim = anchors @ contrast.T / self.temperature
        sim = sim - sim.max(dim=1, keepdim=True).values.detach()
        mask_pos = (anchor_y[:, None] == contrast_y[None, :]).float()
        mask_valid = ok2[None, :] * ok2[:, None]
        logexp = sim - torch.log(torch.sum(torch.exp(sim) * mask_valid + 1e-30, dim=1,
                                           keepdim=True))
        denom = torch.clamp(torch.sum(mask_pos * mask_valid, dim=1), min=1.0)
        mlpp = torch.sum(mask_pos * mask_valid * logexp, dim=1) / denom
        supcon = -(self.temperature / 0.07) * mlpp
        return torch.sum(supcon * ok2) / torch.clamp(ok2.sum(), min=1.0)

    def loss(self, state, batch):
        d = self.draw(state, batch)
        params, buf, labels = state.params, state.mvars["buffer"], batch["label"]
        logits, feats = self.forward(params, batch["x"], train=True)
        w = batch_weight(batch)
        loss = masked_cross_entropy(logits, labels, w, state.seen_mask)
        if self.task_free or state.task > 0:
            pos_idx, neg_idx, ok = self._mine(buf, labels, state.task, d["pos_noise"],
                                              d["neg_noise"])
            pos_src, pos_y = buf["bx"][pos_idx], buf["by"][pos_idx]
            neg_src, neg_y = buf["bx"][neg_idx], buf["by"][neg_idx]
            if self.use_minimal:  # in-batch pairs first, the buffer's where none
                mpx, mpy, mnx, mny, mok = self._mine_minimal(
                    batch["image"], labels, w, d["min_pos_noise"], d["min_neg_noise"])
                use = mok > 0
                pos_src = torch.where(use[:, None, None, None], mpx, pos_src)
                neg_src = torch.where(use[:, None, None, None], mnx, neg_src)
                pos_y, neg_y = torch.where(use, mpy, pos_y), torch.where(use, mny, neg_y)
                ok = torch.maximum(ok, mok)
            # one forward over [pos; neg]: the pair sets share the batch's
            # statistics
            pn = torch.cat([self.augment(state.rng, pos_src), self.augment(state.rng, neg_src)])
            _, pn_h = self.forward(params, pn, train=True, update_stats=False)
            b = labels.shape[0]
            supcon = self._supcon(feats, pn_h[:b], pn_h[b:], labels, pos_y, neg_y, ok * w)
            # SupCon replaces the CE once the buffer holds an image or,
            # task-free, from task 1 on
            has_buf = buf["n_seen"] > 0
            loss = torch.where(has_buf | (state.task > 0) if self.task_free else has_buf,
                               supcon, loss)
            # the replay CE: the only term on the head once SupCon engages
            loss = loss + self.replay_ce(state, d)
        return loss, {"logits": logits, "draws": d}
