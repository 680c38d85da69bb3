"""Weights made from the seed on the device, in a few large calls, and
copied into the program's modules by name.

A configuration's file lists its leaves as a spec: ``(group, name, shape,
dist, scale, offset, dtype)``. Each leaf is ``offset + scale * z``, with z
standard normal (``dist`` "normal") or uniform on [0, 1) ("uniform"), cut
from one flat draw of each kind, then cast to the dtype it is served in. The
groups name the program's module trees (the trainable parameters, a frozen
backbone, a distillation teacher); the reference reads the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Leaf = Tuple[str, str, Tuple[int, ...], str, float, float, str]


def make(spec: Sequence[Leaf], seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: {name: tensor}} for ``spec`` and ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7_919 + 17) % (2 ** 63))
    totals = {"normal": 0, "uniform": 0}
    for _, _, shape, dist, _, _, _ in spec:
        totals[dist] += math.prod(shape)
    flat = {
        "normal": torch.randn(totals["normal"], generator=gen, device=device),
        "uniform": torch.rand(totals["uniform"], generator=gen, device=device),
    }
    at = {"normal": 0, "uniform": 0}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, name, shape, dist, scale, offset, dtype in spec:
        n = math.prod(shape)
        z = flat[dist][at[dist]:at[dist] + n].view(shape)
        at[dist] += n
        out.setdefault(group, {})[name] = (offset + scale * z).to(DTYPES[dtype])
    return out


def install(module: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into ``module``'s parameters and buffers of the same
    names; every one of them must be given, at its shape."""
    own = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    missing, extra = sorted(set(own) - set(values)), sorted(set(values) - set(own))
    if missing or extra:
        raise ValueError(f"weights do not match the module: missing {missing[:5]}, "
                         f"unknown {extra[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            if tuple(t.shape) != tuple(values[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} against "
                                 f"{tuple(values[name].shape)}")
            t.copy_(values[name])
