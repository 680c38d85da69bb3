"""Seeding: host RNGs are seeded once per run, and every random draw of the
port goes through an explicit ``torch.Generator`` made here."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def init_seed(seed: int = 0, deterministic: bool = True) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    # cuDNN picks its convolution algorithm deterministically when asked
    torch.backends.cudnn.benchmark = not deterministic
    torch.backends.cudnn.deterministic = bool(deterministic)


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
