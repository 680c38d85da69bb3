"""The grouped-head attention forward of ``tools/exp_flash_kernel.py`` at ViT
shapes (B 128, H 12, S 197 and 222, D 64, bf16), against the plain ``xla``
forward (``_xla_attention``).

    python -m libcontinual_tpu_torch.tools.exp_flash_kernel [--device cuda]

``make_flash(G)`` is the CUDA kernel of ``ops/csrc/generic_attention.cuh`` in
the mode of ``fwd_kernel`` (``_kernel_v2``'s function on Sq == Skv). The JAX
tool sweeps G, the TPU's slab of heads per program; the CUDA kernel has no
such parameter, so every G is the same configuration and one line is
printed for it. Times are CUDA events on a card and the host clock with
``--device cpu``; the error is the max against the f32 forward.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from libcontinual_tpu_torch.ops import attention as A
from libcontinual_tpu_torch.tools.bench_attention import timeit

#: the JAX tool's slab sizes: one CUDA configuration for all of them
SLABS = (2, 4, 8, 12, 16)


def make_flash(G: int = 8):
    def flash(q, k, v, scale):
        return A.attention_variant(q, k, v, scale, "flash")

    return flash


def main(argv: Optional[List[str]] = None) -> Dict[int, dict]:
    """Returns {S: {"xla_ms", "flash_ms", "err"}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    B, H, D = args.b, 12, 64
    print(f"B {B} H {H} D {D} bf16 (" + ("cuda events, " + torch.cuda.get_device_name(device)
                                        if device.type == "cuda" else
                                        f"{device.type}, host clock") + ")", flush=True)
    results = {}
    for S in (197, 222):
        scale = 1.0 / np.sqrt(D)
        rng = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
                   .to(device, torch.bfloat16) for _ in range(3))
        print(f"--- S={S} ---")
        xla_s = timeit(lambda qq: A.xla_attention_plain(qq, k, v, scale), (q,), args.iters, device)
        print(f"xla fwd: {xla_s * 1e3:.3f} ms", flush=True)
        o1 = A.xla_attention_plain(q.float(), k.float(), v.float(), scale)
        fl = make_flash()
        err = float((o1 - fl(q, k, v, scale).float()).abs().max())
        flash_s = timeit(lambda qq: fl(qq, k, v, scale), (q,), args.iters, device)
        print(f"flash G={'/'.join(map(str, SLABS))} (one configuration; err {err:.4f}): "
              f"{flash_s * 1e3:.3f} ms", flush=True)
        results[S] = {"xla_ms": xla_s * 1e3, "flash_ms": flash_s * 1e3, "err": err}
    return results


if __name__ == "__main__":
    main()
