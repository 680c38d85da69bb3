"""Continual task streams: class-incremental splits over in-memory uint8
arrays (``libcontinual_tpu/data/continual.py``). The trainer moves each
task's arrays to the device once and batches by on-device indexing."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from libcontinual_tpu_torch.data import native
from libcontinual_tpu_torch.data.source import load_source


@dataclasses.dataclass
class TaskData:
    """One task's data. ``labels`` are final (post class-permutation) ids."""

    images: np.ndarray  # uint8 (N, H, W, 3)
    labels: np.ndarray  # int32 (N,)
    class_lo: int  # label range [class_lo, class_hi) for this task
    class_hi: int

    def __len__(self) -> int:
        return len(self.labels)


def build_class_map(
    num_classes: int,
    class_order: Optional[Sequence[int]] = None,
    seed: Optional[int] = None,
) -> np.ndarray:
    """``orig_to_new[orig_label] = new_label``, from an explicit
    ``class_order`` or a permutation drawn by ``np.random.RandomState(seed)``."""
    if class_order is not None:
        perm = np.asarray(class_order, np.int64)
        if len(perm) != num_classes:
            raise ValueError(
                f"class_order has {len(perm)} entries for {num_classes} classes"
            )
    else:
        perm = np.random.RandomState(seed).permutation(num_classes)
    orig_to_new = np.empty(num_classes, np.int64)
    orig_to_new[perm] = np.arange(num_classes)
    return orig_to_new


class ContinualStream:
    """Task stream over one split: ``task(t)`` for training, ``tasks_up_to(t)``
    for evaluation."""

    def __init__(
        self,
        images: np.ndarray,
        labels_new: np.ndarray,
        task_num: int,
        init_cls_num: int,
        inc_cls_num: int,
    ):
        self.task_num = task_num
        self.init_cls_num = init_cls_num
        self.inc_cls_num = inc_cls_num
        self.num_classes = init_cls_num + inc_cls_num * (task_num - 1)
        self._tasks: List[TaskData] = []
        for t in range(task_num):
            lo, hi = self.class_range(t)
            sel = np.nonzero((labels_new >= lo) & (labels_new < hi))[0]
            self._tasks.append(
                TaskData(
                    images=native.gather_rows(images, sel),
                    labels=labels_new[sel].astype(np.int32),
                    class_lo=lo,
                    class_hi=hi,
                )
            )

    def class_range(self, t: int):
        lo = 0 if t == 0 else self.init_cls_num + (t - 1) * self.inc_cls_num
        hi = lo + (self.init_cls_num if t == 0 else self.inc_cls_num)
        return lo, hi

    def task(self, t: int) -> TaskData:
        return self._tasks[t]

    def tasks_up_to(self, t: int) -> List[TaskData]:
        return self._tasks[: t + 1]


def build_stream(config: Dict, mode: str, orig_to_new: Optional[np.ndarray] = None):
    """Load a split and build its task stream. Returns (stream, orig_to_new)."""
    src = load_source(config, mode)
    num_classes_total = len(src["class_names"])
    if orig_to_new is None:
        orig_to_new = build_class_map(
            num_classes_total,
            class_order=config.get("class_order"),
            seed=config.get("seed"),
        )
    labels_new = orig_to_new[src["labels"]]
    stream = ContinualStream(
        src["images"],
        labels_new,
        task_num=config["task_num"],
        init_cls_num=config["init_cls_num"],
        inc_cls_num=config["inc_cls_num"],
    )
    by_new = [""] * num_classes_total
    for orig, name in enumerate(src.get("class_names") or []):
        by_new[int(orig_to_new[orig])] = name
    stream.class_names = by_new
    return stream, orig_to_new
