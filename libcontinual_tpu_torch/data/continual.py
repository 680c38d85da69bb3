"""Continual task streams: class-incremental splits over in-memory uint8
arrays (``libcontinual_tpu/data/continual.py``). The trainer moves each
task's arrays to the device once and batches by on-device indexing.

Also the long-tailed streams that DAP trains on (``imb_type`` /
``imb_factor`` / ``shuffle``): each class of the train split subsampled to a
count profile, drawn with the same numpy generator as the JAX package."""

from __future__ import annotations

import dataclasses
import random
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

    def concat(self, other: "TaskData") -> "TaskData":
        """This task's rows, then ``other``'s (task data, then the replay
        buffer)."""
        return TaskData(
            images=native.concat_rows(self.images, other.images),
            labels=np.concatenate([self.labels, other.labels]),
            class_lo=min(self.class_lo, other.class_lo),
            class_hi=max(self.class_hi, other.class_hi),
        )


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


def imbalance_profile(
    imb_type: str,
    cls_num: int,
    task_num: int,
    init_cls_num: int,
    inc_cls_num: int,
    img_max: int,
    imb_factor: float,
) -> List[int]:
    """Per-class sample counts of a long-tailed stream; an unknown
    ``imb_type`` keeps every class at ``img_max``."""
    out: List[int] = []
    if imb_type in ("exp", "exp_re"):
        for c in range(cls_num):
            out.append(max(int(img_max * imb_factor ** (c / (cls_num - 1.0))), 1))
        if imb_type == "exp_re":
            out.reverse()
    elif imb_type in ("exp_max", "exp_max_re"):
        cls_per_group = cls_num // task_num
        num = img_max
        for c in range(cls_num):
            if (c + 1) % cls_per_group == 1:
                num = img_max * imb_factor ** (c / (cls_num - 1.0))
            out.append(int(num))
        if imb_type == "exp_max_re":
            out.reverse()
    elif imb_type == "exp_min":
        cls_per_group = cls_num // task_num
        num = img_max
        for c in range(cls_num):
            if (c + 1) % cls_per_group == 1:
                num = img_max * imb_factor ** ((c + cls_per_group - 1) / (cls_num - 1.0))
            out.append(int(num))
    elif imb_type in ("half", "half_re"):
        cls_per_group = cls_num // task_num
        num = 1
        for c in range(cls_num):
            out.append(int(min(num, img_max)))
            if (c + 1) % cls_per_group == 0:
                num *= 2
        if imb_type == "half":
            out.reverse()
    elif imb_type == "halfbal":
        cls_per_group = cls_num // task_num
        total = sum(img_max * cls_per_group / (2**i) for i in range(task_num))
        out.extend([int(total / cls_num)] * cls_num)
    elif imb_type == "oneshot":
        out.extend([1] * cls_num)
    elif imb_type == "step":
        out.extend([int(img_max)] * (cls_num // 2))
        out.extend([int(img_max * imb_factor)] * (cls_num // 2))
    elif imb_type == "fewshot":
        for c in range(cls_num):
            out.append(int(img_max if c < 50 else img_max * 0.01))
    else:
        out.extend([int(img_max)] * cls_num)
    return out


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

    def apply_imbalance(self, imb_type: str, imb_factor: float, seed: int = 0,
                        shuffle: bool = False) -> None:
        """Subsample each class to the ``imb_type`` profile, in place. With
        ``shuffle`` the profile's groups of ``inc_cls_num`` classes, and the
        classes within each group, are shuffled first."""
        rng = np.random.RandomState(seed)
        img_max = max(
            int(np.sum(t.labels == c)) for t in self._tasks for c in range(t.class_lo, t.class_hi)
        )
        counts = imbalance_profile(
            imb_type, self.num_classes, self.task_num, self.init_cls_num,
            self.inc_cls_num, img_max, imb_factor,
        )
        if shuffle:
            groups = [
                counts[i: i + self.inc_cls_num]
                for i in range(0, self.num_classes, self.inc_cls_num)
            ]
            rng.shuffle(groups)
            for g in groups:
                rng.shuffle(g)
            counts = [n for g in groups for n in g]
        for t, td in enumerate(self._tasks):
            keep_idx = []
            for c in range(td.class_lo, td.class_hi):
                idx = np.nonzero(td.labels == c)[0]
                rng.shuffle(idx)
                keep_idx.append(idx[: counts[c]])
            keep = np.concatenate(keep_idx)
            self._tasks[t] = TaskData(
                images=native.gather_rows(td.images, keep),
                labels=td.labels[keep],
                class_lo=td.class_lo,
                class_hi=td.class_hi,
            )


def build_stream(config: Dict, mode: str, orig_to_new: Optional[np.ndarray] = None):
    """Load a split and build its task stream. Returns (stream, orig_to_new).

    Without a ``class_order``, tiny-imagenet's class order is Python's
    ``random.Random(seed).shuffle`` (the published runs' order), every other
    dataset's a numpy permutation. A train split with ``imb_type`` is made
    long-tailed."""
    src = load_source(config, mode)
    num_classes_total = len(src["class_names"])
    if orig_to_new is None:
        class_order = config.get("class_order")
        if class_order is None and config.get("dataset") == "tiny-imagenet":
            class_order = list(range(num_classes_total))
            random.Random(config.get("seed")).shuffle(class_order)
        orig_to_new = build_class_map(
            num_classes_total, class_order=class_order, seed=config.get("seed"),
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
    if mode == "train" and "imb_type" in config:
        stream.apply_imbalance(
            config["imb_type"],
            config.get("imb_factor", 0.01),
            seed=config.get("seed", 0),
            shuffle=bool(config.get("shuffle", False)),
        )
    return stream, orig_to_new
