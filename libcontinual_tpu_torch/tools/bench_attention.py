"""Attention forward shoot-out at ViT-B/L2P shapes (B 128, H 12, S 197 + 20,
D 64, bf16), the counterpart of ``tools/bench_attention.py``.

    python -m libcontinual_tpu_torch.tools.bench_attention [--only NAME] [--device cuda]

The candidates keep the JAX tool's names. ``xla*`` are the plain PyTorch
versions (``xla_attn`` is ``_xla_attention``; ``xla_manual`` with ``nomax``
and ``bf16_scores``). ``pallas_*`` are the CUDA kernel of
``ops/csrc/generic_attention.cuh`` in the mode of each Pallas body
(``pallas_g8``: ``_kernel_v2``, and so on); the JAX tool's ``pallas_g4`` and
``pallas_g16`` differ from ``pallas_g8`` only in the TPU's heads-per-program
slab, which the CUDA kernel does not have, so they are not repeated.
``pallas_attention`` is the generic op's own kernel (``_attention_kernel``).
``sdpa_flash`` and ``sdpa_cudnn`` are ``scaled_dot_product_attention`` on
its flash and cuDNN backends, the library yardstick (the port never calls
it). Each line gives ms per call (CUDA events over ``--iters`` calls after a
warm-up), TF/s (4 B H Sq Skv D operations) and the max error against
``xla``. With ``--device cpu`` only the plain versions run, timed by the
host clock; the CUDA-only candidates are skipped by name.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from libcontinual_tpu_torch.ops import attention as A


def xla_attn(q, k, v, scale):
    return A.xla_attention_plain(q, k, v, scale)


def xla_manual(q, k, v, scale, nomax=False, bf16_scores=False):
    s = q.float() @ k.float().transpose(-1, -2)
    if bf16_scores:
        s = s.to(torch.bfloat16).float()
    s = s * scale
    if not nomax:
        s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def _sdpa(backend_name: str):
    def run(q, k, v, scale):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(getattr(SDPBackend, backend_name)):
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
    return run


def candidates(scale: float) -> Dict[str, Callable]:
    variant = lambda name: (lambda q, k, v: A.attention_variant(q, k, v, scale, name))  # noqa: E731
    return {
        "xla": lambda q, k, v: xla_attn(q, k, v, scale),
        "pallas_attention": lambda q, k, v: A.attention_forward(q, k, v, scale),
        "pallas_g8": variant("v2"),
        "pallas_g8_nomax": variant("v2_nomax"),
        "pallas_g8_fast": variant("fast"),
        "pallas_g8_bf16sm": variant("fast_bf16sm"),
        "xla_nomax": lambda q, k, v: xla_manual(q, k, v, scale, nomax=True),
        "xla_bf16scores": lambda q, k, v: xla_manual(q, k, v, scale, nomax=True,
                                                     bf16_scores=True),
        "pallas_mmonly_g8": variant("mmonly"),
        "pallas_2d": variant("qblock"),
        "sdpa_flash": lambda q, k, v: _sdpa("FLASH_ATTENTION")(q, k, v, scale),
        "sdpa_cudnn": lambda q, k, v: _sdpa("CUDNN_ATTENTION")(q, k, v, scale),
    }


def _cuda_only(name: str) -> bool:
    return name.startswith(("pallas_", "sdpa_"))


def timeit(fn, args, iters: int, device: torch.device) -> float:
    """Seconds per call: CUDA events around ``iters`` calls after 3 warm-up
    calls on a card; the host clock on the CPU."""
    for _ in range(3):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    """Runs the shoot-out; returns {candidate: {"ms", "tflops", "maxerr"}},
    or {"error": ...} for a candidate that failed, or {"skipped": ...}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--h", type=int, default=12)
    ap.add_argument("--sq", type=int, default=217)
    ap.add_argument("--skv", type=int, default=217)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    rng = np.random.RandomState(0)
    shp_q = (args.b, args.h, args.sq, args.d)
    shp_kv = (args.b, args.h, args.skv, args.d)
    q, k, v = (torch.from_numpy(rng.randn(*shp).astype(np.float32)).to(device, torch.bfloat16)
               for shp in (shp_q, shp_kv, shp_kv))
    scale = 1.0 / np.sqrt(args.d)
    flops = 2 * 2 * args.b * args.h * args.sq * args.skv * args.d
    where = ("cuda events, " + torch.cuda.get_device_name(device) if device.type == "cuda"
             else f"{device.type}, host clock")
    print(f"B {args.b} H {args.h} Sq {args.sq} Skv {args.skv} D {args.d} bf16 ({where})",
          flush=True)

    ref = xla_attn(q, k, v, scale).float()
    results: Dict[str, dict] = {}
    for name, fn in candidates(scale).items():
        if args.only and args.only not in name:
            continue
        if device.type != "cuda" and _cuda_only(name):
            print(f"{name:18s} skipped: CUDA only", flush=True)
            results[name] = {"skipped": "CUDA only"}
            continue
        try:
            if "mmonly" in name:
                err = float("nan")  # diagnostic only, not attention math
            else:
                err = float((fn(q, k, v).float() - ref).abs().max())
            dt = timeit(fn, (q, k, v), args.iters, device)
            results[name] = {"ms": dt * 1e3, "tflops": flops / dt / 1e12, "maxerr": err}
            print(f"{name:18s} {dt*1e3:8.3f} ms  {flops/dt/1e12:7.2f} TF/s  maxerr {err:.4f}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 (one failed candidate does not stop the rest)
            results[name] = {"error": f"{type(e).__name__}: {e}"}
            print(f"{name:18s} FAILED: {type(e).__name__}: {e}", flush=True)
    return results


if __name__ == "__main__":
    main()
