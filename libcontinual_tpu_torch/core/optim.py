"""Optimizers and learning-rate schedules (``libcontinual_tpu/core/optim.py``).

  * The optimizers are ``torch.optim`` classes whose update rules equal the
    JAX package's optax chains: SGD folds weight decay into the gradient
    before momentum, Adam couples its decay the same way, AdamW decouples it.
  * The learning rate is data: the train step sets it before every update
    (:func:`set_lr`), so every scheduler, including the loss-reactive
    PatienceSchedule, drives the same optimizer.
  * :func:`clip_by_global_norm` is optax's rule, not
    ``torch.nn.utils.clip_grad_norm_`` (which adds 1e-6 to the norm).
  * Schedules are host-side objects emitting a per-step lr vector per epoch,
    with the same formulas (CosineSchedule's 99pi/200 form and its K == 1 case
    included).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable

import numpy as np
import torch


# ----------------------------------------------------------------- optimizers


def make_optimizer(name: str, kwargs: Dict[str, Any], params: Iterable[torch.nn.Parameter]):
    """A ``torch.optim`` optimizer over ``params``; its lr is set per step."""
    kw = dict(kwargs)
    kw.pop("lr", None)
    params = list(params)
    name_l = name.lower()
    if name_l == "sgd":
        return torch.optim.SGD(
            params, lr=0.0, momentum=kw.get("momentum", 0.0),
            weight_decay=kw.get("weight_decay", 0.0),
            nesterov=kw.get("nesterov", False),
        )
    if name_l in ("adam", "adamw"):
        b1, b2 = kw.get("betas", (0.9, 0.999))
        cls = torch.optim.Adam if name_l == "adam" else torch.optim.AdamW
        wd = kw.get("weight_decay", 0.0 if name_l == "adam" else 1e-2)
        return cls(params, lr=0.0, betas=(b1, b2), eps=kw.get("eps", 1e-8), weight_decay=wd)
    raise ValueError(f"unknown optimizer '{name}'")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: when the global norm reaches
    ``max_norm``, every gradient becomes ``g / norm * max_norm``. Returns
    the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    keep = norm < max_norm  # stays on the device: no host sync per step
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


# ------------------------------------------------------------------ schedules


class ScheduleController:
    """Per-epoch LR control mirroring the reference scheduler zoo.

    ``step_lrs(epoch)`` -> float lr vector of length ``steps_per_epoch`` for
    that epoch; ``observe(train_loss)`` feeds PatienceSchedule;
    ``should_stop()`` implements its stopping_lr early exit
    (reference core/trainer.py:397-404).
    """

    def __init__(
        self,
        config: Dict[str, Any],
        base_lr: float,
        steps_per_epoch: int,
        total_epochs: int,
        warmup: int = 0,
    ):
        sched = config.get("lr_scheduler") or {"name": "Constant"}
        self.name = sched.get("name", "Constant")
        self.kwargs = dict(sched.get("kwargs") or {})
        self.base_lr = float(base_lr)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.total_epochs = max(int(total_epochs), 1)
        self.warmup = int(warmup or 0)
        # PatienceSchedule runtime state
        self._cur_lr = self.base_lr
        self._best_loss = float("inf")
        self._counter = 0
        # warmup shifts the after-scheduler's clock (reference utils.py:117-126)
        if self.warmup:
            if self.name == "CosineAnnealingLR" and "T_max" in self.kwargs:
                self.kwargs["T_max"] -= self.warmup - 1
            elif self.name == "MultiStepLR" and "milestones" in self.kwargs:
                self.kwargs["milestones"] = [
                    m - self.warmup + 1 for m in self.kwargs["milestones"]
                ]

    # -- epoch-granularity formulas (torch semantics) --
    def _epoch_lr(self, epoch: int) -> float:
        if self.warmup and epoch < self.warmup - 1:
            return self.base_lr * float(epoch + 1) / self.warmup
        e = epoch - (self.warmup - 1) if self.warmup else epoch
        n, kw, base = self.name, self.kwargs, self.base_lr
        if n == "Constant" or n == "LambdaLR":
            return base
        if n == "StepLR":
            return base * kw.get("gamma", 0.1) ** (e // kw["step_size"])
        if n == "MultiStepLR":
            passed = sum(1 for m in kw["milestones"] if e >= m)
            return base * kw.get("gamma", 0.1) ** passed
        if n == "CosineAnnealingLR":
            eta_min = kw.get("eta_min", 0.0)
            t_max = kw["T_max"]
            return eta_min + (base - eta_min) * (1 + math.cos(math.pi * e / t_max)) / 2
        if n == "ExponentialLR":
            return base * kw.get("gamma", 0.9) ** e
        if n == "CosineSchedule":
            # reference core/scheduler.py:47-62 (incl. K == 1 special case)
            k = max(kw.get("K", self.total_epochs), 2) if kw.get("K", 2) != 1 else 2
            return base * math.cos((99 * math.pi * e) / (200 * (k - 1)))
        if n == "PatienceSchedule":
            return self._cur_lr
        raise ValueError(f"unknown lr_scheduler '{self.name}'")

    def step_lrs(self, epoch: int) -> np.ndarray:
        s = self.steps_per_epoch
        if self.name == "CosineAnnealingWarmUp":
            # per-iteration schedule (reference core/scheduler.py:64-89)
            wl = self.kwargs.get("warmup_length", 0)
            # T_max: 0 in configs means "computed at runtime" (the reference
            # builds this scheduler per task with T_max = epochs * steps,
            # reference trainer.py:175-180)
            t_max = self.kwargs.get("T_max") or self.total_epochs * s
            it = epoch * s + np.arange(s)
            warm = self.base_lr * (it + 1) / max(wl, 1)
            cos = self.base_lr * 0.5 * (1 + np.cos(np.pi * it / t_max))
            return np.where(it < wl, warm, cos).astype(np.float32)
        return np.full(s, self._epoch_lr(epoch), np.float32)

    @property
    def per_iteration(self) -> bool:
        return self.name == "CosineAnnealingWarmUp"

    def observe(self, train_loss: float) -> None:
        if self.name != "PatienceSchedule":
            return
        if train_loss < self._best_loss:
            self._best_loss = train_loss
            self._counter = 0
        else:
            self._counter += 1
        if self._counter >= self.kwargs["patience"]:
            self._cur_lr /= self.kwargs["factor"]
            self._counter = 0

    def should_stop(self) -> bool:
        if self.name != "PatienceSchedule":
            return False
        stopping = self.kwargs.get("stopping_lr")
        return stopping is not None and self._cur_lr < stopping


def make_schedule(
    config: Dict[str, Any],
    steps_per_epoch: int,
    total_epochs: int,
    task_idx: int = 0,
) -> ScheduleController:
    opt_key = "init_optimizer" if task_idx == 0 and "init_optimizer" in config else "optimizer"
    base_lr = float(config[opt_key]["kwargs"].get("lr", 0.1))
    return ScheduleController(
        config,
        base_lr,
        steps_per_epoch,
        total_epochs,
        warmup=int(config.get("warmup") or 0),
    )
