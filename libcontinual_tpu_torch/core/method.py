"""The Method protocol (``libcontinual_tpu/core/method.py``).

A method owns its modules and its pipelines and exposes the JAX package's
hooks: ``start_task``, ``before_task`` and ``reset_optimizer`` at the start of
a task, ``build_train_data``, ``epochs_for_task`` and ``override_schedule``
for its training data and schedule, ``after_task``, ``on_buffer_updated``
and ``extra_phases`` at its end, ``loss`` for a batch, ``train_step`` for one
update (with the learning rate passed in per step) and ``eval_step`` for
predictions. The state it works on is a
:class:`~libcontinual_tpu_torch.core.state.TrainState`.

The seams of one update, in ``train_step``'s order: ``transform_grads``
edits the gradients, ``trainable_mask`` zeroes the frozen entries' gradients
and, after ``opt.step()``, restores their values (so the optimizer's own
weight decay cannot move them either), and ``post_update`` sees the new
state. ``_tx_for_task`` chooses a task's optimizer and
``trainable_parameters`` the parameters it covers (the optimizer is rebuilt
every task).

The defaults are the JAX base class's, Finetune's semantics: a backbone with
running statistics (``params["backbone"]``, its BatchNorm statistics as
module buffers) and a linear head (``params["head"]``), plain CE on the full
head, logits for evaluation and the backbone's eval-mode features for
herding.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch import nn

from libcontinual_tpu_torch.core.optim import make_optimizer, set_lr
from libcontinual_tpu_torch.core.state import TrainState, make_masks
from libcontinual_tpu_torch.data.transforms import build_transform
from libcontinual_tpu_torch.models import backbone_feat_dim, compute_dtype, get_backbone
from libcontinual_tpu_torch.models.heads import LinearHead
from libcontinual_tpu_torch.utils.seeding import make_generator


def masked_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    class_mask: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Weighted-mean CE; ``class_mask`` (num_class,) excludes classes by
    setting their logits to -1e30. ``label_smoothing`` s gives
    ``(1 - s) NLL + s * mean over the unmasked classes of -log p``."""
    if class_mask is not None:
        logits = torch.where(class_mask[None, :] > 0, logits, -1e30)
    ll = F.log_softmax(logits, dim=-1)
    nll = -ll.gather(-1, labels[:, None].long())[:, 0]
    if label_smoothing > 0.0:
        if class_mask is not None:
            valid = (class_mask > 0).to(ll.dtype)[None, :]
            smooth = -torch.sum(ll * valid, dim=-1) / torch.clamp(valid.sum(dim=-1), min=1.0)
        else:
            smooth = -ll.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if weight is None:
        return nll.mean()
    return torch.sum(nll * weight) / torch.clamp(weight.sum(), min=1.0)


def weighted_accuracy(logits, labels, weight=None):
    correct = (logits.argmax(dim=-1) == labels).float()
    if weight is None:
        return correct.mean()
    return torch.sum(correct * weight) / torch.clamp(weight.sum(), min=1.0)


class Method:
    """Base class: config parsing, pipelines, optimizers, the step loop and
    the hooks shared by every method, with Finetune's semantics by default."""

    #: the trainer concatenates the replay buffer into the task data and
    #: updates it after each task
    concat_buffer: bool = True
    #: the trainer validates between a task's epochs (PRAKA turns it off)
    validate_enabled: bool = True

    def __init__(self, config: Dict[str, Any], device):
        self.config = config
        self.device = torch.device(device)
        ck = (config.get("classifier") or {}).get("kwargs") or {}
        self.num_class = int(
            ck.get("num_class")
            or config["init_cls_num"] + config["inc_cls_num"] * (config["task_num"] - 1)
        )
        self.task_num = int(config["task_num"])
        self.init_cls_num = int(config["init_cls_num"])
        self.inc_cls_num = int(config["inc_cls_num"])
        self.kwargs = ck
        # distillation teachers run in train mode on the batch's statistics
        # (the reference trainer's per-epoch model.train() reaches them);
        # ``teacher_batch_stats: false`` runs them on their running statistics
        self.teacher_train = bool(ck.get("teacher_batch_stats", True))
        self.dtype = compute_dtype(config)
        self._build_pipelines()

    @property
    def feat_dim(self) -> int:
        """The backbone's feature width (``classifier.kwargs.feat_dim``, else
        the ResNet table); raises for a backbone that has neither."""
        return backbone_feat_dim(self.config)

    def _backbone_kind(self) -> str:
        name = self.config["backbone"]["name"].lower()
        if "vit" in name or "sinet" in name:
            return "vit"
        if "alexnet" in name:
            return "alexnet"
        if "clip" in name:
            return "clip"
        return "resnet"

    def _build_pipelines(self):
        cfg = self.config
        common = dict(
            dataset=str(cfg.get("dataset", "cifar100")),
            backbone=self._backbone_kind(),
            image_size=int(cfg.get("image_size", 32)),
        )
        self.train_pipeline = build_transform(cfg.get("train_trfms"), mode="train", **common)
        self.test_pipeline = build_transform(cfg.get("test_trfms"), mode="test", **common)
        if not cfg.get("augment", True):
            # `augment: false` trains on the eval transforms
            self.train_pipeline = self.test_pipeline

    # ------------------------------------------------------------------ state

    def init_state(self, seed: int, sample_input_hw: Tuple[int, int, int]) -> TrainState:
        """The backbone and a linear head, drawn from a CPU generator seeded
        with ``seed``, on the method's device."""
        gen = make_generator(seed, "cpu")
        backbone = get_backbone(self.config, gen)
        head = LinearHead(self.feat_dim, self.num_class, generator=gen)
        return self.backbone_state(backbone, head, seed)

    def backbone_state(self, backbone: nn.Module, head: nn.Module, seed: int,
                       **extra: nn.Module) -> TrainState:
        """A state around given modules (``extra`` beside the backbone and the
        head: OCM's projection, PRAKA's single head): all trainable, f32
        parameters."""
        params = nn.ModuleDict({"backbone": backbone, "head": head, **extra}).to(self.device)
        seen, prev = make_masks(self.num_class, 0, self.init_cls_num, self.device)
        state = TrainState(
            params=params,
            opt_state=self._tx_for_task(0, params.parameters()),
            mvars={},
            rng=make_generator(seed, self.device),
            step=0,
            task=0,
            seen_mask=seen,
            prev_mask=prev,
        )
        state.mvars.update(self.init_mvars(state))
        return state

    def init_mvars(self, state: TrainState) -> Dict[str, Any]:
        """Method-owned variables of a new state."""
        return {}

    def trainable_parameters(self, state: TrainState):
        """The parameters the task's optimizer covers."""
        return [p for p in state.params.parameters() if p.requires_grad]

    def _tx_for_task(self, task_idx: int, params) -> torch.optim.Optimizer:
        """The optimizer of task ``task_idx`` over ``params``: the config's
        (``init_optimizer`` at task 0 where there is one)."""
        key = "init_optimizer" if task_idx == 0 and "init_optimizer" in self.config else "optimizer"
        node = self.config[key]
        return make_optimizer(node["name"], node.get("kwargs") or {}, params)

    def reset_optimizer(self, state: TrainState, task_idx: int) -> TrainState:
        """Fresh optimizer state per task."""
        state.opt_state = self._tx_for_task(task_idx, self.trainable_parameters(state))
        return state

    # ------------------------------------------------------------------ hooks

    def start_task(self, state: TrainState, task_idx: int, class_lo: int, class_hi: int) -> TrainState:
        """Trainer-called: update the task scalar and class masks."""
        state.seen_mask, state.prev_mask = make_masks(
            self.num_class, class_lo, class_hi, self.device
        )
        state.task = int(task_idx)
        return state

    def before_task(self, state: TrainState, task_idx: int, task_data) -> TrainState:
        """Trainer-called after ``start_task`` and before the optimizer is
        reset. A hook that replaces parameter values writes them in place
        under ``torch.no_grad()``, so the optimizer's ``Parameter`` objects
        stay the same."""
        return state

    def after_task(self, state: TrainState, task_idx: int, task_data) -> TrainState:
        """Trainer-called after the task's training epochs."""
        return state

    def on_buffer_updated(self, state: TrainState, task_idx: int, buffer) -> TrainState:
        """Trainer-called after it refreshed the replay buffer (iCaRL
        recomputes its exemplar class means here)."""
        return state

    def extra_phases(self, trainer, state: TrainState, task_idx: int, task_data) -> TrainState:
        """Method-owned training phases after the buffer update."""
        return state

    def epochs_for_task(self, task_idx: int, default: int) -> int:
        return default

    def build_train_data(self, task_data, buffer, task_idx: int):
        """The task's training data, or None for the trainer's default (task
        data, then the buffer)."""
        return None

    def override_schedule(self, task_idx: int, steps_per_epoch: int, epochs: int):
        """A schedule to use instead of the config's, or None."""
        return None

    # ----------------------------------------------------------------- compute

    def augment(self, gen: Optional[torch.Generator], images: torch.Tensor, train: bool = True):
        pipeline = self.train_pipeline if train else self.test_pipeline
        return pipeline(gen if train else None, images)

    def apply_backbone(self, params, x, train: bool, update_stats: bool = True) -> Dict:
        """The backbone's outputs; in train mode its BatchNorm layers use the
        batch's statistics and, with ``update_stats``, update their running
        ones in place."""
        return params["backbone"](x, train=train, update_stats=update_stats)

    def forward(self, params, x, train: bool, update_stats: bool = True):
        """(logits, features) through the backbone and the head."""
        feats = self.apply_backbone(params, x, train, update_stats)["features"]
        return params["head"](feats), feats

    def loss(self, state: TrainState, batch) -> Tuple[torch.Tensor, Dict]:
        """Plain CE on the full head (Finetune)."""
        logits, feats = self.forward(state.params, batch["x"], train=True)
        ce = masked_cross_entropy(logits, batch["label"], batch.get("weight"))
        return ce, {"logits": logits, "features": feats}

    def transform_grads(self, state: TrainState) -> None:
        """Edit the gradients in place after the backward pass."""

    def trainable_mask(self, state: TrainState) -> Optional[Dict[nn.Parameter, torch.Tensor]]:
        """0/1 masks, broadcastable to their parameters, of the entries an
        update may change, or None for all of them."""
        return None

    def post_update(self, state: TrainState, batch, aux) -> TrainState:
        """After the optimizer step. The running statistics need nothing
        here: the train-mode forward updated them in place."""
        return state

    def class_range(self, task_id: int) -> Tuple[int, int]:
        """[lo, hi) of task ``task_id``'s classes."""
        lo = 0 if task_id == 0 else self.init_cls_num + (task_id - 1) * self.inc_cls_num
        return lo, lo + (self.init_cls_num if task_id == 0 else self.inc_cls_num)

    def task_range_mask(self, task_id: int) -> torch.Tensor:
        """(num_class,) f32 mask of task ``task_id``'s classes; -1 gives every
        class."""
        if task_id < 0:
            return torch.ones(self.num_class, device=self.device)
        lo, hi = self.class_range(task_id)
        idx = torch.arange(self.num_class, device=self.device)
        return ((idx >= lo) & (idx < hi)).float()

    def train_step(self, state: TrainState, batch, lr: float):
        batch = dict(batch)
        batch["x"] = self.augment(state.rng, batch["image"], train=True)
        loss, aux = self.loss(state, batch)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss.backward()
        self.transform_grads(state)
        frozen = []
        mask = self.trainable_mask(state)
        if mask:
            with torch.no_grad():
                for p, m in mask.items():
                    if p.grad is not None:
                        p.grad.mul_(m)
                    frozen.append((p, m > 0, p.detach().clone()))
        set_lr(opt, lr)
        opt.step()
        if frozen:
            with torch.no_grad():
                for p, keep, before in frozen:
                    p.copy_(torch.where(keep, p, before))
        state.step += 1
        state = self.post_update(state, batch, aux)
        with torch.no_grad():
            acc = weighted_accuracy(aux["logits"], batch["label"], batch.get("weight"))
        return state, {"loss": loss.detach(), "acc": acc}

    def eval_logits(self, state: TrainState, x, task_id: int) -> torch.Tensor:
        return self.forward(state.params, x, train=False)[0]

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch, task_id: int) -> torch.Tensor:
        x = self.augment(None, batch["image"], train=False)
        return self.eval_logits(state, x, task_id).argmax(dim=-1)

    @torch.no_grad()
    def herding_features(self, state: TrainState, x) -> torch.Tensor:
        """The features the herding buffer update ranks."""
        return self.apply_backbone(state.params, x, train=False)["features"]
