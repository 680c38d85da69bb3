"""PRAKA, prototype reminiscence and augmented asymmetric knowledge
aggregation (Shi & Ye, ICCV 2023), non-exemplar class-incremental learning
(``libcontinual_tpu/methods/praka.py``).

  * two heads: ``head``, the joint head over ``4 * num_class`` rotation
    classes, and ``single``, the ``num_class`` classifier; every batch trains
    on its 4 rot90s with labels ``4 * y + k``, both CEs at temperature 0.1,
    plus the KL of the single head against the rotation-aggregated joint
    predictions;
  * from task 1 on: prototype reminiscence (each old class's saved feature
    mean, mixed with a random feature of the rotated stack by a Beta(0.5,
    0.5) coefficient and a random sign, through both heads and the same
    aggregation KL) and the L2 norm of the feature difference against the
    frozen model of the previous task over the whole rotated stack;
  * ``after_task`` saves each class's prototype (eval-mode features of
    train-augmented images, the padded rows dropped) and refreshes the
    teacher (in train mode on the batch's statistics unless
    ``teacher_batch_stats: false``);
  * one forward a step moves the running statistics, the rotated stack's;
  * evaluation runs the single head, masked to the classes seen; the trainer
    does not validate between epochs (``validate_enabled = False``).

A step's draws come from :meth:`PRAKA.draw`, so a test can feed the JAX
package's. ``torch.distributions.Beta`` takes no generator: Beta(1/2, 1/2) is
the arcsine law, drawn exactly by its inverse CDF ``sin^2(pi u / 2)``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import batch_iter, snapshot
from libcontinual_tpu_torch.methods.er import gumbel
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


def _masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(torch.where(mask[None, :] > 0, logits, -1e30), dim=-1)


def _aggregation_kl(agg: torch.Tensor, single: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum KL(softmax(agg) || softmax(single)) over the masked classes, over
    the rows; ``agg`` takes no gradient."""
    target = _masked_log_softmax(agg.detach(), mask)
    return torch.sum(target.exp() * (target - _masked_log_softmax(single, mask)))


@METHODS.register("PRAKA")
class PRAKA(Method):
    validate_enabled = False
    concat_buffer = False

    def __init__(self, config, device):
        super().__init__(config, device)
        self.kd_weight = float(self.kwargs.get("kd_weight", 15.0))
        self.proto_weight = float(
            self.kwargs.get("protoAug_weight", self.kwargs.get("proto_weight", 15.0)))
        self.temp = float(self.kwargs.get("temp", 0.1))

    def init_state(self, seed, sample_input_hw):
        gen = make_generator(seed, "cpu")
        backbone = get_backbone(self.config, gen)
        head = LinearHead(self.feat_dim, 4 * self.num_class, generator=gen)
        single = LinearHead(self.feat_dim, self.num_class, generator=gen)
        return self.backbone_state(backbone, head, seed, single=single)

    def init_mvars(self, state):
        return {
            "teacher": snapshot(state.params),
            "protos": torch.zeros(self.num_class, self.feat_dim, device=self.device),
            "proto_valid": torch.zeros(self.num_class, device=self.device),
        }

    def draw(self, state, batch) -> Dict[str, torch.Tensor]:
        """The prototype reminiscence's numbers for one step of B images,
        from ``state.rng``: ``cls`` (B,), an old class by Gumbel-argmax over
        those with a prototype; ``lam`` (B, 1) ~ Beta(1/2, 1/2); ``row`` (B,),
        a row of the rotated stack; ``sign`` (B, 1), a fair coin."""
        b, gen, dev = batch["label"].shape[0], state.rng, self.device
        old_valid = state.mvars["proto_valid"] * state.prev_mask
        g = gumbel(gen, (b, self.num_class), dev)
        return {
            "cls": (torch.log(old_valid[None, :] + 1e-30) + g).argmax(1),
            "lam": torch.sin(0.5 * math.pi * torch.rand((b, 1), generator=gen, device=dev)) ** 2,
            "row": torch.randint(0, 4 * b, (b,), generator=gen, device=dev),
            "sign": torch.rand((b, 1), generator=gen, device=dev) < 0.5,
        }

    def loss(self, state, batch):
        d = self.draw(state, batch)
        params, mask, T = state.params, state.seen_mask, self.temp
        x, y, w = batch["x"], batch["label"], batch.get("weight")
        b = x.shape[0]
        xs = torch.cat([torch.rot90(x, k, dims=(1, 2)) for k in range(4)])
        ys = torch.cat([4 * y + k for k in range(4)])
        logits, feats = self.forward(params, xs, train=True)
        joint_mask = mask.repeat_interleave(4)
        joint_ce = masked_cross_entropy(logits / T, ys, None if w is None else w.repeat(4),
                                        joint_mask)
        single = params["single"](feats[:b])
        single_ce = masked_cross_entropy(single / T, y, w, mask)
        # rotation k's rows score their k::4 label slots
        agg = sum(logits[k * b:(k + 1) * b, k::4] for k in range(4)) / 4.0
        loss = joint_ce + single_ce + _aggregation_kl(agg, single, mask) / b
        if state.task > 0:
            loss = loss + self._old_class_terms(state, xs, feats, d)
        return loss, {"logits": torch.where(mask[None, :] > 0, single, -1e30), "draws": d}

    def _old_class_terms(self, state, xs, feats, d):
        """The weighted prototype and feature-KD terms, 0 until a prototype
        of an old class exists."""
        params, mask, T = state.params, state.seen_mask, self.temp
        with torch.no_grad():
            t_feats = self.apply_backbone(state.mvars["teacher"], xs, train=self.teacher_train,
                                          update_stats=False)["features"]
        # torch.dist: the L2 norm of the difference over the rotated stack
        kd = torch.sqrt(torch.sum((feats - t_feats) ** 2) + 1e-12)

        cls, lam = d["cls"], d["lam"]
        lam = torch.where(lam > 0.6, lam * 0.6, lam)
        f_mix = feats[d["row"]].detach()
        proto = state.mvars["protos"][cls]
        pf = torch.where(d["sign"], (1 + lam) * proto - lam * f_mix,
                         (1 - lam) * proto + lam * f_mix)
        aug_single = params["single"](pf)
        aug_joint = params["head"](pf)
        loss_proto = (masked_cross_entropy(aug_single / T, cls, None, mask)
                      + masked_cross_entropy(aug_joint / T, 4 * cls, None,
                                             mask.repeat_interleave(4))
                      + _aggregation_kl(aug_joint[:, 0::4], aug_single, mask) / cls.shape[0])
        on = (torch.sum(state.mvars["proto_valid"] * state.prev_mask) > 0).float()
        return on * (self.proto_weight * loss_proto + self.kd_weight * kd)

    @torch.no_grad()
    def after_task(self, state, task_idx, task_data):
        """Each trained class's prototype: the mean eval-mode feature of its
        train-augmented images (the augmentation seeded with ``seed +
        task_idx``); then the teacher."""
        gen = make_generator(int(self.config.get("seed", 0)) + task_idx, self.device)
        feats, labels = [], []
        for im, lb, w in batch_iter(task_data.images, task_data.labels,
                                    int(self.config["batch_size"]), self.device):
            x = self.augment(gen, im, train=True)
            keep = w > 0
            feats.append(self.apply_backbone(state.params, x, train=False)["features"][keep])
            labels.append(lb[keep])
        feats, labels = torch.cat(feats), torch.cat(labels)
        protos, valid = state.mvars["protos"].clone(), state.mvars["proto_valid"].clone()
        for c in torch.unique(labels).tolist():
            protos[c] = feats[labels == c].mean(dim=0)
            valid[c] = 1.0
        state.mvars.update(protos=protos, proto_valid=valid, teacher=snapshot(state.params))
        return state

    def eval_logits(self, state, x, task_id):
        feats = self.apply_backbone(state.params, x, train=False)["features"]
        return torch.where(state.seen_mask[None, :] > 0, state.params["single"](feats), -1e30)
