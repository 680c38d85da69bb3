"""iCaRL, Incremental Classifier and Representation Learning (Rebuffi et al.,
CVPR 2017) (``libcontinual_tpu/methods/icarl.py``).

  * training loss: CE over the seen classes plus T = 2 KD of the old classes'
    logits against the network frozen after the previous task (the teacher,
    in train mode on the batch's statistics unless ``teacher_batch_stats:
    false``; its running statistics never move);
  * the trainer's herding buffer picks the exemplars (``core/buffer.py``);
  * nearest-mean-of-exemplars (NME) evaluation once class means exist: the
    class whose normalised exemplar mean is nearest to the features, used
    only when the means cover every seen class (mid-task validation of a new
    task falls back to the logits).

The class means are a ``(num_class, feat_dim)`` tensor in ``mvars`` with a
per-class validity flag; the choice between NME and the logits is made on
the device, so an evaluation step does not wait on the host.
"""

from __future__ import annotations

import torch

from libcontinual_tpu_torch.core.method import Method, masked_cross_entropy
from libcontinual_tpu_torch.methods.common import batch_iter, kd_loss, normalized, snapshot
from libcontinual_tpu_torch.registry import METHODS


@METHODS.register("ICarl")
class ICarl(Method):
    def __init__(self, config, device):
        super().__init__(config, device)
        self.T = float(self.kwargs.get("T", 2.0))

    def init_mvars(self, state):
        return {
            "teacher": snapshot(state.params),
            "class_means": torch.zeros(self.num_class, self.feat_dim, device=self.device),
            "nme_ready": False,
            "mean_valid": torch.zeros(self.num_class, device=self.device),
        }

    def loss(self, state, batch):
        logits, _ = self.forward(state.params, batch["x"], train=True)
        ce = masked_cross_entropy(logits, batch["label"], batch.get("weight"), state.seen_mask)
        if state.task == 0:  # no old classes: the KD term is 0
            return ce, {"logits": logits}
        with torch.no_grad():
            t_logits, _ = self.forward(state.mvars["teacher"], batch["x"],
                                       train=self.teacher_train, update_stats=False)
        kd = kd_loss(logits, t_logits, T=self.T, class_mask=state.prev_mask,
                     weight=batch.get("weight"))
        return ce + kd, {"logits": logits}

    def after_task(self, state, task_idx, task_data):
        state.mvars["teacher"] = snapshot(state.params)
        return state

    @torch.no_grad()
    def on_buffer_updated(self, state, task_idx, buffer):
        """Recompute the exemplar class means: the mean of each class's
        normalised eval-mode features, normalised."""
        if buffer.labels is None or len(buffer.labels) == 0:
            return state
        feats_all, labels_all = [], []
        for im, lb, w in batch_iter(buffer.images, buffer.labels, int(self.config["batch_size"]),
                                    self.device):
            x = self.augment(None, im, train=False)
            f = self.apply_backbone(state.params, x, train=False)["features"].float()
            keep = w > 0
            feats_all.append(f[keep])
            labels_all.append(lb[keep])
        feats = normalized(torch.cat(feats_all))
        labels = torch.cat(labels_all)
        means = torch.zeros(self.num_class, self.feat_dim, device=self.device)
        valid = torch.zeros(self.num_class, device=self.device)
        for c in torch.unique(labels).tolist():
            means[c] = normalized(feats[labels == c].mean(dim=0))
            valid[c] = 1.0
        state.mvars.update(class_means=means, nme_ready=True, mean_valid=valid)
        return state

    def eval_logits(self, state, x, task_id):
        logits, feats = self.forward(state.params, x, train=False)
        seen = state.seen_mask[None, :] > 0
        logits = torch.where(seen, logits, -1e30)
        if not state.mvars["nme_ready"]:
            return logits
        # NME scores: the negative squared distance to each class mean
        d = torch.sum((feats[:, None, :] - state.mvars["class_means"][None]) ** 2, dim=-1)
        nme = torch.where(seen, -d, -1e30)
        covered = torch.where(state.seen_mask > 0, state.mvars["mean_valid"], 1.0).min() > 0
        return torch.where(covered, nme, logits)
