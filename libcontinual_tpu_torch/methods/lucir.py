"""LUCIR, Learning a Unified Classifier Incrementally via Rebalancing (Hou et
al., CVPR 2019) (``libcontinual_tpu/methods/lucir.py``).

  * a cosine head (:class:`~libcontinual_tpu_torch.models.heads.CosineLinear`)
    with a learnable ``sigma``; CE over the seen classes on its logits;
  * from task 1 on, ``cur_lamda`` times the less-forget term ``1 - cos`` between
    the features and the teacher's (the backbone frozen after the previous
    task, in train mode on the batch's statistics unless
    ``teacher_batch_stats: false``), with ``cur_lamda = lamda * sqrt(n_old /
    inc)``, plus ``lw_mr`` times the margin ranking of each old-class sample's
    true cosine against the top-``K`` new-class cosines;
  * before a task t > 0, each new class's row of the head is imprinted from
    the normalised mean of its normalised eval-mode features, scaled by the
    mean norm of the old rows, and the old rows are frozen through
    ``trainable_mask``: gradient and update both, so the optimizer's weight
    decay cannot shrink them either.
"""

from __future__ import annotations

import math

import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import batch_iter, normalized, snapshot
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import CosineLinear
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


def margin_ranking(scores, labels, prev_mask, seen_mask, K: int, dist: float, weight=None):
    """For each old-class sample, the hinge ``max(dist - (s_true - s_k), 0)``
    over the top-``K`` new-class scores ``s_k``, averaged over (old samples x
    K)."""
    n_old = prev_mask.sum()
    gt = scores.gather(1, labels[:, None].long())[:, 0]
    new = (seen_mask - prev_mask)[None, :] > 0
    topk = torch.topk(torch.where(new, scores, -torch.inf), K, dim=1).values
    viol = torch.clamp(dist - (gt[:, None] - topk), min=0.0)
    hard = (labels < n_old).float()
    if weight is not None:
        hard = hard * weight
    return torch.sum(viol * hard[:, None]) / torch.clamp(hard.sum() * K, min=1.0)


@METHODS.register("LUCIR")
class LUCIR(Method):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.K = int(self.kwargs.get("K", 2))
        self.lw_mr = float(self.kwargs.get("lw_mr", 1.0))
        self.dist = float(self.kwargs.get("dist", 0.5))
        self.lamda_base = float(self.kwargs.get("lamda", 5.0))

    def init_state(self, seed, sample_input_hw):
        gen = make_generator(seed, "cpu")
        backbone = get_backbone(self.config, gen)
        return self.backbone_state(backbone, CosineLinear(self.feat_dim, self.num_class, gen), seed)

    def init_mvars(self, state):
        return {
            "teacher": snapshot(state.params),
            "cur_lamda": 0.0,  # set by before_task
            "head_col_mask": torch.ones(self.num_class, device=self.device),
        }

    def before_task(self, state, task_idx, task_data):
        if task_idx == 0:
            state.mvars["cur_lamda"] = self.lamda_base
            return state
        n_old = self.init_cls_num + (task_idx - 1) * self.inc_cls_num
        state.mvars["cur_lamda"] = self.lamda_base * math.sqrt(n_old / self.inc_cls_num)
        cols = torch.ones(self.num_class, device=self.device)
        cols[:n_old] = 0.0
        state.mvars["head_col_mask"] = cols
        self.imprint(state, task_data, n_old)
        return state

    @torch.no_grad()
    def imprint(self, state, task_data, n_old: int) -> None:
        """Each new class's head row from its features (see the module
        docstring), written in place."""
        w = state.params["head"].weight  # (num_class, feat)
        old_norm = torch.linalg.vector_norm(w[:n_old], dim=1).mean()
        bs = int(self.config["batch_size"])
        for c in range(task_data.class_lo, task_data.class_hi):
            sel = (task_data.labels == c).nonzero()[0]
            if not len(sel):
                continue
            feats = []
            for im, _, wt in batch_iter(task_data.images[sel], task_data.labels[sel], bs,
                                        self.device):
                x = self.augment(None, im, train=False)
                f = self.apply_backbone(state.params, x, train=False)["features"].float()
                feats.append(f[wt > 0])
            emb = normalized(normalized(torch.cat(feats)).mean(dim=0))
            w[c] = emb * old_norm

    def trainable_mask(self, state):
        """The old classes' rows of the head stay as they are."""
        return {state.params["head"].weight: state.mvars["head_col_mask"][:, None]}

    def loss(self, state, batch):
        feats = self.apply_backbone(state.params, batch["x"], train=True)["features"]
        head = state.params["head"]
        scores = head.scores(feats)  # before sigma
        logits = torch.where(state.seen_mask[None, :] > 0, scores * head.sigma, -1e30)
        w = batch.get("weight")
        ce = masked_cross_entropy(logits, batch["label"], w, state.seen_mask)
        if state.task == 0:
            return ce, {"logits": logits}
        with torch.no_grad():
            ref = self.apply_backbone(state.mvars["teacher"], batch["x"],
                                      train=self.teacher_train, update_stats=False)["features"]
        lf = 1.0 - torch.sum(normalized(feats.float()) * normalized(ref.float()), dim=1)
        lf = torch.sum(lf * w) / torch.clamp(w.sum(), min=1.0) if w is not None else lf.mean()
        mr = margin_ranking(scores, batch["label"], state.prev_mask, state.seen_mask,
                            self.K, self.dist, w)
        return ce + state.mvars["cur_lamda"] * lf + self.lw_mr * mr, {"logits": logits}

    def after_task(self, state, task_idx, task_data):
        state.mvars["teacher"] = snapshot(state.params)
        return state

    def eval_logits(self, state, x, task_id):
        feats = self.apply_backbone(state.params, x, train=False)["features"]
        logits = state.params["head"](feats)
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)
