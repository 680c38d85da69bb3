"""Peaks of one NVIDIA H100 SXM and the least time of an attention or
convolution launch at a given shape.

A copy of the bound arithmetic of ``chip_smoke.py`` (``_bound``, the packed
qkv bounds inside ``phase_kernel_timing``, ``_pqkv_bounds``, ``_mqkv_bounds``
and ``_conv_bounds``), kept here so that a change to the
program cannot move the yardstick. Bytes count each input read once and each
output written once; operations count the products the algorithm needs
(two for a forward attention, five for its backward: the recomputed scores,
dP, dV, dQ and dK). Every function returns seconds.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and the dense bf16 tensor-core
# rate, both at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound(nbytes: float, flops: float) -> float:
    """The larger of bytes over the bandwidth and operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def qkv_bounds(b: int, s: int, d: int, h: int):
    """(forward, backward) of the packed-qkv kernels in bf16: read qkv (and
    the output gradient), write o (or dqkv)."""
    per_image = s * 3 * d + s * d
    one = 2 * b * h * s * s * (d // h)  # one product over S x S
    return (bound(2 * b * per_image, 2 * one),
            bound(2 * b * (per_image + s * 3 * d), 5 * one))


def pqkv_bounds(b: int, s: int, p: int, d: int, h: int):
    """(forward, backward) of the prefix kernels in bf16: read qkv, pk, pv
    (and g), write o (or dqkv, dpk, dpv)."""
    per_image = s * 3 * d + 2 * p * d + s * d
    one = 2 * b * h * s * (s + p) * (d // h)
    return (bound(2 * b * per_image, 2 * one),
            bound(2 * b * (per_image + s * 3 * d + 2 * p * d), 5 * one))


def mqkv_bounds(b: int, s: int, d: int, h: int):
    """(forward, backward) of the masked kernels in bf16: read qkv (and g)
    and the f32 (S, S) mask, write o (or dqkv)."""
    per_image = s * 3 * d + s * d
    one = 2 * b * h * s * s * (d // h)
    return (bound(2 * b * per_image + 4 * s * s, 2 * one),
            bound(2 * b * (per_image + s * 3 * d) + 4 * s * s, 5 * one))


def conv_bounds(b: int, h: int, w: int, c: int, o: int):
    """(forward, weight-gradient) of the 3x3 conv kernels in bf16."""
    act_x, act_y, flops = 2 * b * h * w * c, 2 * b * h * w * o, 2 * b * h * w * c * o * 9
    return (bound(act_x + 2 * 9 * c * o + act_y, flops),
            bound(act_x + act_y + 4 * 9 * c * o, flops))


def launch_bound(kind: str, shape) -> float:
    """The bound of one recorded launch (see ``trace.record_launches``)."""
    if kind in ("qkv_fwd", "qkv_bwd"):
        return qkv_bounds(*shape)[kind == "qkv_bwd"]
    if kind in ("pqkv_fwd", "pqkv_bwd"):
        return pqkv_bounds(*shape)[kind == "pqkv_bwd"]
    if kind in ("mqkv_fwd", "mqkv_bwd"):
        return mqkv_bounds(*shape)[kind == "mqkv_bwd"]
    raise ValueError(f"no bound for launch kind {kind!r}")
