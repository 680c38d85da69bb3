"""Dataset sources: a whole split in host memory as uint8 arrays,
``{"images": uint8 (N, H, W, 3), "labels": int32 (N,), "class_names": [...]}``
with labels in the original class ids.

The port has the ``synthetic`` source of ``libcontinual_tpu/data/source.py``
so far; any other dataset name raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from libcontinual_tpu_torch.registry import DATASETS


def make_synthetic(
    num_classes: int = 100,
    per_class: int = 100,
    image_size: int = 32,
    seed: int = 0,
    noise: float = 0.35,
    sample_seed: Optional[int] = None,
) -> Dict:
    """Deterministic learnable data: a smooth random pattern per class, plus
    noise and a random shift per sample. ``seed`` fixes the prototypes (shared
    by train and test); ``sample_seed`` varies the draw per split."""
    proto_rng = np.random.RandomState(seed)
    rng = np.random.RandomState(seed if sample_seed is None else sample_seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    protos = []
    for _ in range(num_classes):
        freq = proto_rng.uniform(1.0, 4.0, size=(2, 3))
        phase = proto_rng.uniform(0, 2 * np.pi, size=(2, 3))
        amp = proto_rng.uniform(0.5, 1.0, size=3)
        p = 0.5 + 0.25 * (
            amp * np.sin(2 * np.pi * freq[0] * yy[..., None] + phase[0])
            + amp * np.sin(2 * np.pi * freq[1] * xx[..., None] + phase[1])
        )
        protos.append(p)
    protos = np.stack(protos)  # (C, H, W, 3)

    n = num_classes * per_class
    labels = np.repeat(np.arange(num_classes), per_class).astype(np.int32)
    base = protos[labels]
    shifts = rng.randint(-3, 4, size=(n, 2))
    imgs = np.empty_like(base)
    for i in range(n):
        imgs[i] = np.roll(base[i], tuple(shifts[i]), axis=(0, 1))
    imgs = imgs + rng.randn(n, image_size, image_size, 3).astype(np.float32) * noise
    images = np.clip(imgs * 255.0, 0, 255).astype(np.uint8)
    order = rng.permutation(n)
    return {
        "images": images[order],
        "labels": labels[order],
        "class_names": [f"class_{i}" for i in range(num_classes)],
    }


@DATASETS.register("synthetic")
def synthetic_source(config: Dict, mode: str) -> Dict:
    num_classes = config.get("num_classes") or (
        config["init_cls_num"] + config["inc_cls_num"] * (config["task_num"] - 1)
    )
    per_class = config.get("per_class", 100 if mode == "train" else 20)
    base = config.get("seed", 0)
    return make_synthetic(
        num_classes=num_classes,
        per_class=per_class,
        # stored geometry, resized to the model's input inside the step
        image_size=config.get("storage_size") or config.get("image_size", 32),
        seed=base,
        sample_seed=base + (0 if mode == "train" else 10_000),
    )


def load_source(config: Dict, mode: str) -> Dict:
    """``dataset: synthetic`` selects the synthetic source. A real dataset
    whose ``data_root`` is missing raises, rather than training on synthetic
    data that looks like results; one whose root exists raises too, since
    the port has no file readers yet."""
    name = config.get("dataset", "cifar100")
    data_root = os.path.expanduser(str(config.get("data_root", "")))
    if name == "synthetic":
        return DATASETS.get("synthetic")(config, mode)
    if not data_root or not os.path.exists(data_root):
        raise FileNotFoundError(
            f"dataset '{name}' requested but data_root "
            f"{data_root!r} does not exist; set dataset: synthetic for the "
            "no-download smoke path"
        )
    raise NotImplementedError(
        f"dataset '{name}': the PyTorch port reads only the synthetic source so far"
    )
