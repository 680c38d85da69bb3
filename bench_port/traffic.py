"""The benchmark's traffic: class-incremental image streams made from a seed.

A vectorised copy of the arithmetic of the port's
``data/source.py::make_synthetic``, run on the device: one smooth random
pattern a class (two sine gratings a channel), each image that pattern
rolled by a random shift of -3..3 pixels on each axis, plus Gaussian noise,
clipped and stored as uint8 NHWC. The train and test splits share the
patterns and draw their shifts and noise apart. The same seed gives the same
images on one device kind; the numbers differ from ``make_synthetic``'s
(torch's generator, not numpy's), the distribution is the same.

A traffic file (``traffic/<name>.json``) holds the sizes the generator reads
(``num_classes``, ``per_class``, ``test_per_class``, ``image_size``,
``noise``) and the job that runs on them (``task``, ``batch_size``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

#: the generator's defaults: CIFAR-100's geometry and make_synthetic's noise
DEFAULTS = {"num_classes": 100, "per_class": 500, "test_per_class": 100,
            "image_size": 32, "noise": 0.35}


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    # seeds may exceed 32 bits; each stream gets its own 64-bit seed
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def _patterns(num_classes: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """(C, H, W, 3) f32 class patterns: 0.5 + 0.25 (a sin(2 pi f_y y + p_y)
    + a sin(2 pi f_x x + p_x)) per channel, f in [1, 4), p in [0, 2 pi),
    a in [0.5, 1)."""
    freq = torch.rand(num_classes, 2, 3, generator=gen, device=device) * 3.0 + 1.0
    phase = torch.rand(num_classes, 2, 3, generator=gen, device=device) * (2 * math.pi)
    amp = torch.rand(num_classes, 3, generator=gen, device=device) * 0.5 + 0.5
    grid = torch.arange(size, dtype=torch.float32, device=device) / size
    ys = grid[None, :, None, None]
    xs = grid[None, None, :, None]
    wave_y = torch.sin(2 * math.pi * freq[:, None, None, 0, :] * ys + phase[:, None, None, 0, :])
    wave_x = torch.sin(2 * math.pi * freq[:, None, None, 1, :] * xs + phase[:, None, None, 1, :])
    return 0.5 + 0.25 * (amp[:, None, None, :] * wave_y + amp[:, None, None, :] * wave_x)


def _split(patterns: torch.Tensor, per_class: int, noise: float,
           gen: torch.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """``per_class`` images of every class, shuffled: uint8 (N, H, W, 3) and
    int64 labels (N,)."""
    c, size = patterns.shape[0], patterns.shape[1]
    dev = patterns.device
    n = c * per_class
    labels = torch.arange(c, device=dev).repeat_interleave(per_class)
    shifts = torch.randint(-3, 4, (n, 2), generator=gen, device=dev)
    pix = torch.arange(size, device=dev)
    # np.roll by s: out[y] = in[(y - s) mod size]
    rows = (pix[None, :] - shifts[:, :1]) % size
    cols = (pix[None, :] - shifts[:, 1:]) % size
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    chunk = 8192
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        img = patterns[labels[sl, None, None], rows[sl, :, None], cols[sl, None, :]]
        img = img + torch.randn(img.shape, generator=gen, device=dev) * noise
        out[sl] = torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8)
    order = torch.randperm(n, generator=gen, device=dev)
    return out[order].cpu().numpy(), labels[order].cpu().numpy()


def generate(params: Dict, seed: int, device) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{"train": (images, labels), "test": (images, labels)} for a traffic
    file's parameters and a seed."""
    p = {**DEFAULTS, **params}
    device = torch.device(device)
    patterns = _patterns(int(p["num_classes"]), int(p["image_size"]),
                         _generator(seed, 0, device), device)
    return {
        "train": _split(patterns, int(p["per_class"]), float(p["noise"]),
                        _generator(seed, 1, device)),
        "test": _split(patterns, int(p["test_per_class"]), float(p["noise"]),
                       _generator(seed, 2, device)),
    }
