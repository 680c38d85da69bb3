"""DER, Dynamically Expandable Representation (Yan et al., CVPR 2021)
(``libcontinual_tpu/methods/der.py``).

  * ``task_num`` feature extractors (``params["backbone"]``, a
    ``ModuleList``), each drawn in turn from the init generator; task t
    (``mvars["n_active"]`` = t + 1) trains extractor t, warm-started before
    the task from extractor t - 1 (parameters and running statistics);
  * the train step runs only the active prefix 0..t. The old extractors run
    in train mode on the batch's statistics (unless ``teacher_batch_stats:
    false``) without touching their running statistics, and take no
    gradient; only the newest one's statistics advance;
  * the classifier sees the active features concatenated and zero-padded to
    ``task_num * feat_dim``; from task 1 on an auxiliary head (drawn anew
    every task) on the newest extractor's features learns the targets
    ``max(y - known + 1, 0)``;
  * the task's optimizer covers the newest extractor and the two heads, so
    the old extractors stay as they are, weight decay included;
  * evaluation and the herding features use the same padded concatenation,
    in eval mode;
  * ``weight_align: true`` scales the new classes' head rows after each task
    t > 0 as WA does; off by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.core.state import TrainState, make_masks
from libcontinual_tpu_torch.methods.common import head_kernel, set_head_kernel
from libcontinual_tpu_torch.methods.wa import align_weights
from libcontinual_tpu_torch.models import get_backbone
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils.seeding import make_generator


@METHODS.register("DER")
class DER(Method):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.aux_classes = self.inc_cls_num + 1
        self.weight_align = bool(self.kwargs.get("weight_align", False))
        self.seed = 0

    def init_state(self, seed, sample_input_hw):
        gen = make_generator(seed, "cpu")
        self.seed = int(seed)
        extractors = nn.ModuleList(get_backbone(self.config, gen) for _ in range(self.task_num))
        params = nn.ModuleDict({
            "backbone": extractors,
            "head": LinearHead(self.feat_dim * self.task_num, self.num_class, generator=gen),
            "aux": LinearHead(self.feat_dim, self.aux_classes, generator=gen),
        }).to(self.device)
        seen, prev = make_masks(self.num_class, 0, self.init_cls_num, self.device)
        state = TrainState(params=params, opt_state=None, mvars={"n_active": 1},
                           rng=make_generator(seed, self.device), step=0, task=0,
                           seen_mask=seen, prev_mask=prev)
        state.opt_state = self._tx_for_task(0, self.trainable_parameters(state))
        return state

    def trainable_parameters(self, state):
        p = state.params
        return [*p["backbone"][state.mvars["n_active"] - 1].parameters(), *p["head"].parameters(),
                *p["aux"].parameters()]

    # ------------------------------------------------------------ forward

    def _flat(self, feats):
        """(B, n * feat_dim) zero-padded to (B, task_num * feat_dim)."""
        flat = torch.cat(feats, dim=1)
        return F.pad(flat, (0, (self.task_num - len(feats)) * self.feat_dim))

    def loss(self, state, batch):
        n, x = state.mvars["n_active"], batch["x"]
        extractors = state.params["backbone"]
        with torch.no_grad():
            old = [extractors[i](x, train=self.teacher_train, update_stats=False)["features"]
                   for i in range(n - 1)]
        cur = extractors[n - 1](x, train=True)["features"]
        logits = state.params["head"](self._flat(old + [cur]))
        w = batch.get("weight")
        loss = masked_cross_entropy(logits, batch["label"], w, state.seen_mask)
        if n > 1:
            known = state.prev_mask.sum().long()
            aux_t = torch.clamp(batch["label"] - known + 1, min=0)
            loss = loss + masked_cross_entropy(state.params["aux"](cur), aux_t, w)
        return loss, {"logits": logits}

    # ------------------------------------------------------------- hooks

    @torch.no_grad()
    def before_task(self, state, task_idx, task_data):
        state.mvars["n_active"] = task_idx + 1
        if task_idx > 0:
            extractors = state.params["backbone"]
            extractors[task_idx].load_state_dict(extractors[task_idx - 1].state_dict())
            gen = make_generator(self.seed + 1000 + task_idx, "cpu")
            aux = LinearHead(self.feat_dim, self.aux_classes, generator=gen)
            state.params["aux"].load_state_dict(aux.state_dict())
        return state

    def after_task(self, state, task_idx, task_data):
        if task_idx > 0 and self.weight_align:
            set_head_kernel(state.params, align_weights(head_kernel(state.params),
                                                        *self.class_range(task_idx)))
        return state

    @torch.no_grad()
    def features(self, state, x):
        """The active extractors' eval-mode features, concatenated and
        zero-padded to ``task_num * feat_dim``."""
        extractors = state.params["backbone"]
        return self._flat([extractors[i](x, train=False)["features"]
                           for i in range(state.mvars["n_active"])])

    def eval_logits(self, state, x, task_id):
        logits = state.params["head"](self.features(state, x))
        return torch.where(state.seen_mask[None, :] > 0, logits, -1e30)

    def herding_features(self, state, x):
        return self.features(state, x)
