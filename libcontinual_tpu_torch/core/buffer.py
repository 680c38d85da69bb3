"""Replay buffers (``libcontinual_tpu/core/buffer.py``).

A buffer is a pair of host arrays, uint8 images and int32 labels. At the
start of a task the trainer concatenates them behind the task's arrays, so
replay goes through the same on-device batches as the task's own images.

Update strategies, run by the trainer after each task:
  * ``random``: a uniform random subsample of (task data + old buffer) down
    to ``buffer_size``, no per-class quota;
  * ``herding``: iCaRL's greedy mean-feature selection (:func:`_herding_order`,
    a loop on the device over each class's candidates) on the method's
    features, after the old exemplars are cut to the new per-class quota by
    keeping each class's first ones;
  * ``equal_random`` / ``balance_random``: a per-class quota, old exemplars
    subsampled at random.
The draws of the random strategies are ``np.random.RandomState(seed)``'s, as
in the JAX package, so both pick the same exemplars.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from libcontinual_tpu_torch.data import native
from libcontinual_tpu_torch.data.continual import TaskData
from libcontinual_tpu_torch.registry import BUFFERS
from libcontinual_tpu_torch.utils.trace import TRACER


def _herding_order(feats: torch.Tensor) -> torch.Tensor:
    """iCaRL herding: greedily pick the sample whose addition keeps the
    running mean of the chosen ones closest to the class mean.

    feats: (N, D) L2-normalised f32 features. Returns the selection order
    (N,) int64; the first k entries are the k chosen exemplars. Ties go to
    the lower index (``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does). Every step stays on the features' device."""
    n, d = feats.shape
    mu = feats.mean(dim=0)
    chosen_sum = torch.zeros(d, dtype=feats.dtype, device=feats.device)
    taken = torch.zeros(n, dtype=torch.bool, device=feats.device)
    order = torch.zeros(n, dtype=torch.int64, device=feats.device)
    for i in range(n):
        cand = (chosen_sum[None, :] + feats) / (i + 1.0)
        dist = torch.sum((cand - mu[None, :]) ** 2, dim=1)
        j = torch.argmin(torch.where(taken, torch.inf, dist))
        chosen_sum = chosen_sum + feats[j]
        taken[j] = True
        order[i] = j
    return order


class LinearBuffer:
    """A host-side exemplar store of fixed capacity. ``device`` is where the
    herding search runs."""

    def __init__(self, buffer_size: int = 0, batch_size: int = 128,
                 strategy: str = "herding", device="cpu", **_):
        self.buffer_size = int(buffer_size)
        self.batch_size = int(batch_size)
        self.strategy = strategy
        self.device = torch.device(device)
        self.total_classes = 0
        self.images: Optional[np.ndarray] = None  # uint8 (M, H, W, 3)
        self.labels: Optional[np.ndarray] = None  # int32 (M,)

    def __len__(self):
        return 0 if self.labels is None else len(self.labels)

    def as_task_data(self) -> Optional[TaskData]:
        if self.labels is None or len(self.labels) == 0:
            return None
        return TaskData(images=self.images, labels=self.labels,
                        class_lo=int(self.labels.min()), class_hi=int(self.labels.max()) + 1)

    # ---------------------------------------------------------------- updates

    def update(self, task_data: TaskData,
               feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None, seed: int = 0):
        """The post-task update. ``feature_fn`` maps uint8 images to features
        and is needed for herding; an unknown strategy raises."""
        if self.buffer_size <= 0:
            return
        if self.strategy == "herding":
            if feature_fn is None:
                raise ValueError("herding needs a feature_fn")
            self._herding_update(task_data, feature_fn)
        elif self.strategy in ("random", "equal_random", "balance_random"):
            self._random_update(task_data, seed)
        else:
            raise ValueError(
                f"unknown buffer strategy {self.strategy!r}; expected one of "
                "herding/random/equal_random/balance_random"
            )

    def _quota(self) -> int:
        return self.buffer_size // max(self.total_classes, 1)

    def _shrink_old(self, per_cls: int, rng: Optional[np.random.RandomState] = None):
        """Cut each class of the stored exemplars to ``per_cls``: its first
        ones without ``rng`` (herding order ranks them), a random subset
        with it."""
        if self.labels is None:
            return
        keep = []
        for c in np.unique(self.labels):
            idx = np.nonzero(self.labels == c)[0]
            if rng is not None:
                idx = rng.permutation(idx)
            keep.append(idx[:per_cls])
        keep = np.concatenate(keep)
        self.images = native.gather_rows(self.images, keep)
        self.labels = self.labels[keep]

    def _append(self, images: np.ndarray, labels: np.ndarray):
        if self.labels is None:
            self.images, self.labels = images.copy(), labels.copy()
        else:
            self.images = native.concat_rows(self.images, images)
            self.labels = np.concatenate([self.labels, labels])

    def _herding_update(self, task_data: TaskData, feature_fn):
        per_cls = self._quota()
        self._shrink_old(per_cls)
        for c in range(task_data.class_lo, task_data.class_hi):
            sel = np.nonzero(task_data.labels == c)[0]
            if len(sel) == 0:
                continue
            feats = np.asarray(feature_fn(task_data.images[sel]), np.float32)
            feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
            order = _herding_order(torch.from_numpy(feats).to(self.device)).cpu().numpy()
            pick = sel[order[: min(per_cls, len(sel))]]
            # the search runs over every candidate of the class to keep per_cls
            TRACER.count("buffer.herding_iters", len(sel), cls=c)
            TRACER.count("buffer.exemplars_kept", len(pick), cls=c)
            self._append(task_data.images[pick], task_data.labels[pick])

    def _random_update(self, task_data: TaskData, seed: int):
        rng = np.random.RandomState(seed)
        per_cls = self._quota()
        if self.strategy in ("equal_random", "balance_random"):
            self._shrink_old(per_cls, rng)
            for c in range(task_data.class_lo, task_data.class_hi):
                sel = np.nonzero(task_data.labels == c)[0]
                rng.shuffle(sel)
                pick = sel[:per_cls]
                self._append(task_data.images[pick], task_data.labels[pick])
        else:
            if self.labels is None:
                pool_im, pool_lb = task_data.images, task_data.labels
            else:
                pool_im = native.concat_rows(task_data.images, self.images)
                pool_lb = np.concatenate([task_data.labels, self.labels])
            perm = rng.permutation(len(pool_lb))[: self.buffer_size]
            self.images = native.gather_rows(pool_im, perm)
            self.labels = pool_lb[perm].copy()


class LinearSpiltBuffer(LinearBuffer):
    """BiC's buffer with a train / validation split: ``split_ratio`` of each
    class's exemplars (at least one, never the whole class) go to the
    bias-correction validation set."""

    def __init__(self, buffer_size: int = 0, batch_size: int = 128,
                 strategy: str = "herding", split_ratio: float = 0.1, **kw):
        super().__init__(buffer_size, batch_size, strategy, **kw)
        self.split_ratio = float(split_ratio)

    def split(self, seed: int = 0):
        """(train part, validation part) as TaskData, or (None, None)."""
        if self.labels is None:
            return None, None
        rng = np.random.RandomState(seed)
        train_idx, val_idx = [], []
        for c in np.unique(self.labels):
            idx = np.nonzero(self.labels == c)[0]
            rng.shuffle(idx)
            if self.split_ratio <= 0.0 or len(idx) <= 1:
                n_val = 0
            else:
                n_val = max(1, int(len(idx) * self.split_ratio))
            n_val = min(n_val, len(idx) - 1)
            val_idx.append(idx[:n_val])
            train_idx.append(idx[n_val:])
        tr, va = np.concatenate(train_idx), np.concatenate(val_idx)

        def part(idx):
            return TaskData(images=self.images[idx], labels=self.labels[idx],
                            class_lo=int(self.labels[idx].min()),
                            class_hi=int(self.labels[idx].max()) + 1)

        return (part(tr), part(va)) if len(va) else (part(tr), None)


BUFFERS.register("LinearBuffer")(LinearBuffer)
BUFFERS.register("LinearHerdingBuffer")(
    lambda **kw: LinearBuffer(**{**kw, "strategy": "herding"})
)
BUFFERS.register("LinearSpiltBuffer")(LinearSpiltBuffer)
BUFFERS.register("OnlineBuffer")(LinearBuffer)  # the online methods own their device slabs
BUFFERS.register("ERBuffer")(LinearBuffer)


def build_buffer(config: Dict, device="cpu") -> LinearBuffer:
    node = config.get("buffer") or {"name": "LinearBuffer", "kwargs": {}}
    return BUFFERS.get(node["name"])(**{**(node.get("kwargs") or {}), "device": device})
