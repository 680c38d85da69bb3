"""Packed-qkv self-attention for the ViT stack, and the generic attention op.

Counterpart of ``fused_qkv_attention`` in ``libcontinual_tpu/ops/attention.py``:
``(B, S, 3D)`` qkv laid out as ``[q | k | v]`` -> ``(B, S, D)``, with the
head split done inside the kernel. On a CUDA tensor the forward and backward
are the hand-written kernels of ``csrc/attention.cu``; on a CPU tensor
they are the plain PyTorch versions below, which keep the TPU kernel bodies'
rounding points (P cast to the input dtype before ``P . v``; at bf16, dS cast
before the dq/dk products). Any other device raises.

That is the ``qkv`` mode of one packed-qkv op with three: the ``prefix`` mode
(``prefix_attention.py``) adds per-image prompt keys and values, the
``masked`` mode (``masked_attention.py``) an additive mask. Each mode module
holds its plain versions, input checks and kernel wrappers; this module holds
what the three share: one autograd node (:class:`_PackedAttention`), one
launch record (:data:`LAUNCHES`, :func:`_launched`) and the one-pass rule
(:func:`onepass`).

Counterpart, too, of the JAX file's generic op, ``attention`` /
``fused_attention``: q ``(B, H, Sq, D)``, k and v ``(B, H, Skv, D)`` with any
``Sq`` and ``Skv``. Its forward is the kernel of ``csrc/generic_attention.cuh``
on a CUDA tensor (the counterpart of ``_attention_kernel``: P kept in f32)
and :func:`attention_plain` on a CPU tensor; its backward is the JAX op's
rematerialising VJP in PyTorch ops. :func:`attention_variant` runs the same
kernel template in the modes of the Pallas variants in
``tools/bench_attention.py`` and ``tools/exp_flash_kernel.py``, for the
measurement tools of :mod:`libcontinual_tpu_torch.tools`.

The package's ``ops/__init__.py`` does not re-export ``attention``: that
would shadow this module's name in ``from libcontinual_tpu_torch.ops import
attention``.
"""

from __future__ import annotations

import ctypes
import importlib
import math
from typing import Dict, Optional, Tuple

import torch

from libcontinual_tpu_torch.utils.trace import TRACER

#: kernel launches per kind, for every kernel of ``csrc/attention.cu``: the
#: packed (``qkv_*``), prefix (``pqkv_*``) and masked (``mqkv_*``) modes of the
#: packed-qkv op, counted by :func:`_launched` only (``<kind>_onepass``: the
#: ``<kind>`` launches that took a one-pass kernel), and the generic forward
#: and its variants (``attn_fwd*``)
LAUNCHES: Dict[str, int] = {
    **{kind + tail: 0 for kind in ("qkv_fwd", "qkv_bwd", "pqkv_fwd", "pqkv_bwd", "mqkv_fwd",
                                   "mqkv_bwd") for tail in ("", "_onepass")},
    **dict.fromkeys(("attn_fwd", "attn_fwd_v2", "attn_fwd_fast", "attn_fwd_mmonly",
                     "attn_fwd_qblock", "attn_fwd_flash"), 0),
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _split_heads(qkv: torch.Tensor, heads: int):
    b, s, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    q, k, v = (
        qkv[..., i * d:(i + 1) * d].reshape(b, s, heads, hd).transpose(1, 2)
        for i in range(3)
    )
    return q, k, v  # (B, H, S, hd) views


def _probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)  # f32


def qkv_attention_plain(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """The forward as the TPU kernel body computes it, in plain PyTorch."""
    b, s, d3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    p = _probs(q, k, scale).to(qkv.dtype)
    o = (p.float() @ v.float()).to(qkv.dtype)  # (B, H, S, hd)
    return o.transpose(1, 2).reshape(b, s, d3 // 3)


def qkv_attention_bwd_plain(
    qkv: torch.Tensor, g: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """The backward as the TPU kernel body computes it: packed ``dqkv``."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, heads)
    gh = g.reshape(b, s, heads, d // heads).transpose(1, 2).float()
    p = _probs(q, k, scale)
    dp = gh @ v.float().transpose(-1, -2)
    dv = p.to(dt).float().transpose(-1, -2) @ gh
    dl = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = (dl @ k.float()) * scale
    dk = (dl.transpose(-1, -2) @ q.float()) * scale
    parts = [t.to(dt).transpose(1, 2).reshape(b, s, d) for t in (dq, dk, dv)]
    return torch.cat(parts, dim=-1)


# ------------------------------------------------------------------ kernels


def _lib() -> ctypes.CDLL:
    from libcontinual_tpu_torch.ops import _build

    return _build.lib("attention")


def _check_packed(qkv: torch.Tensor, heads: int, name: str) -> Tuple[int, int, int, int]:
    """(B, S, D, hd) of a packed qkv tensor that the kernels take; raises on
    the device, dtype, layout, head dim and grid they do not take."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {qkv.dtype} not supported (bf16 or f32)")
    if qkv.dim() != 3 or qkv.shape[2] % 3 != 0:
        raise ValueError(f"{name}: expected (B, S, 3D), got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    b, s, d3 = qkv.shape
    d = d3 // 3
    max_hd = _lib().lct_attn_max_head_dim()  # any sequence length, hd up to this
    if heads < 1 or d % heads != 0 or not 0 < d // heads <= max_hd:
        raise ValueError(f"{name}: head dim {d}/{heads} outside 1..{max_hd}")
    if min(b, s) < 1 or max(b, heads) > 65535:
        raise ValueError(f"{name}: B {b}, S {s}, H {heads} outside the kernels' grid")
    return b, s, d, d // heads


def onepass(keys: int, hd: int, dtype: torch.dtype) -> bool:
    """Whether a packed, prefix or masked forward or backward over ``keys``
    keys (P + S) at head dim ``hd`` takes a one-pass kernel (bf16, hd <= 64,
    at most 256 keys) rather than the streaming ones: the C side's rule,
    ``lct_attn_onepass``, one for both directions."""
    return bool(_lib().lct_attn_onepass(keys, hd, _DTYPES[dtype]))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_grad(g: torch.Tensor, qkv: torch.Tensor, b: int, s: int, d: int,
                name: str) -> torch.Tensor:
    """``g`` as a backward kernel reads it: contiguous, (B, S, D), qkv's dtype
    and device."""
    g = g.contiguous()
    if g.shape != (b, s, d) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(
            f"{name}: gradient {tuple(g.shape)} {g.dtype} on {g.device} does not match "
            f"qkv {tuple(qkv.shape)} {qkv.dtype}"
        )
    return g


def _launched(kind: str, shape: Tuple[int, ...], keys: int, hd: int, dtype: torch.dtype) -> None:
    """Records one launch of a packed, prefix or masked kernel wrapper,
    ``kind`` (``qkv_fwd``, ``pqkv_bwd``, ...) over ``keys`` keys: its count
    and one-pass count in :data:`LAUNCHES`, and for the tracer its ``shape``,
    (B, S, D, heads) or (B, S, P, D, heads) for the prefix mode."""
    LAUNCHES[kind] += 1
    LAUNCHES[kind + "_onepass"] += onepass(keys, hd, dtype)
    TRACER.launch(kind, shape)


def qkv_attention_cuda(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    b, s, d, hd = _check_packed(qkv, heads, "qkv_attention_cuda")
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    err = _lib().lct_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), b, s, heads, hd, _DTYPES[qkv.dtype],
        float(scale), _stream(qkv),
    )
    _raise_on(err, "qkv_attention_cuda")
    _launched("qkv_fwd", (b, s, d, int(heads)), s, hd, qkv.dtype)
    return out


def qkv_attention_bwd_cuda(
    qkv: torch.Tensor, g: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    b, s, d, hd = _check_packed(qkv, heads, "qkv_attention_bwd_cuda")
    g = _check_grad(g, qkv, b, s, d, "qkv_attention_bwd_cuda")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, s), dtype=torch.float32, device=qkv.device)
    err = _lib().lct_qkv_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, s, heads, hd, _DTYPES[qkv.dtype], float(scale), _stream(qkv),
    )
    _raise_on(err, "qkv_attention_bwd_cuda")
    _launched("qkv_bwd", (b, s, d, int(heads)), s, hd, qkv.dtype)
    return dqkv


# ---------------------------------------------------------------- dispatch


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: no implementation for device {t.device}")


#: the packed-qkv op's modes: mode -> (module, stem). The module holds the
#: mode's kernel wrappers ``<stem>_cuda`` and ``<stem>_bwd_cuda`` and its plain
#: versions ``<stem>_plain`` and ``<stem>_bwd_plain``; each takes ``(qkv,
#: *extra, scale, heads)``, the backward ``g`` before ``scale``. The extra
#: inputs are the prefix's ``pk``, ``pv`` and the masked mode's ``mask``.
_MODES: Dict[str, Tuple[str, str]] = {
    "qkv": (__name__, "qkv_attention"),
    "prefix": ("libcontinual_tpu_torch.ops.prefix_attention", "prefix_attention"),
    "masked": ("libcontinual_tpu_torch.ops.masked_attention", "masked_attention"),
}


def _routed(mode: str, backward: bool, qkv: torch.Tensor, *args):
    """One direction of ``mode`` on qkv's device: the kernel wrapper on a CUDA
    tensor, the plain version on a CPU tensor; any other device raises. The
    function is looked up in its module at every call, so a wrapper set there
    (as ``bench_port``'s launch recorder sets one) sees every launch."""
    module, stem = _MODES[mode]
    direction = "backward" if backward else "forward"
    impl = "cuda" if _route(qkv, f"{stem} {direction}") == "cuda" else "plain"
    name = f"{stem}_bwd_{impl}" if backward else f"{stem}_{impl}"
    return getattr(importlib.import_module(module), name)(qkv, *args)


class _PackedAttention(torch.autograd.Function):
    """The packed-qkv op in any of its modes. Saves only qkv and the mode's
    extra inputs: the backward recomputes the probabilities, as the JAX
    package's custom VJPs (``_qkv_attention_core`` and its prefix and masked
    siblings) do. A mask gets no gradient."""

    @staticmethod
    def forward(ctx, mode, scale, heads, qkv, *extra):
        ctx.save_for_backward(qkv, *extra)
        ctx.mode, ctx.scale, ctx.heads = mode, scale, heads
        return _routed(mode, False, qkv, *extra, scale, heads)

    @staticmethod
    def backward(ctx, g):
        qkv, *extra = ctx.saved_tensors
        grads = _routed(ctx.mode, True, qkv, *extra, g, ctx.scale, ctx.heads)
        if isinstance(grads, torch.Tensor):  # dqkv alone: a mask gets no gradient
            grads = (grads, *[None] * len(extra))
        return (None, None, None, *grads)


def _packed_attention(mode: str, qkv: torch.Tensor, scale: float, heads: int,
                      *extra: torch.Tensor) -> torch.Tensor:
    return _PackedAttention.apply(mode, float(scale), int(heads), qkv, *extra)


def fused_qkv_attention(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """Self-attention straight off the packed qkv tensor:
    ``(B, S, 3D) -> (B, S, D)``, differentiable."""
    return _packed_attention("qkv", qkv, scale, heads)


# ------------------------------------------------------- generic attention

LOG2E = 1.4426950408889634
#: variant -> (mode of ``generic_attention.cuh``, launch counter). The Pallas
#: bodies: ``v2`` and ``v2_nomax`` ``_kernel_v2``, ``fast`` and ``fast_bf16sm``
#: ``_kernel_fast``, ``qblock`` ``_kernel_qblock`` and ``mmonly``
#: ``_kernel_mmonly`` of ``tools/bench_attention.py``, ``flash`` ``fwd_kernel``
#: of ``tools/exp_flash_kernel.py``. ``qblock`` computes ``fast``'s function
#: and ``flash`` ``v2``'s (on Sq == Skv): each runs that mode's instantiation.
VARIANTS: Dict[str, Tuple[int, str]] = {
    "v2": (1, "attn_fwd_v2"), "v2_nomax": (2, "attn_fwd_v2"),
    "fast": (3, "attn_fwd_fast"), "fast_bf16sm": (4, "attn_fwd_fast"),
    "qblock": (3, "attn_fwd_qblock"), "mmonly": (5, "attn_fwd_mmonly"),
    "flash": (1, "attn_fwd_flash"),
}
_FAST_MODES = (3, 4)  # scores take scale * log2(e)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The forward as ``_attention_kernel`` computes it: f32 scores, an f32
    softmax with the max subtracted, P kept in f32 for an f32 ``P . v``,
    the output rounded once to q's dtype. (The kernel body's padding to 8
    and ``-1e30`` on padded keys are TPU tiling and change nothing.)"""
    return (_probs(q, k, scale) @ v.float()).to(q.dtype)


def xla_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """``_xla_attention``, the JAX op's CPU and default branch: P rounded to
    q's dtype before ``P . v``. The same function as :func:`attention_plain`
    at f32."""
    p = _probs(q, k, scale).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def _variant(variant: str, q: torch.Tensor, k: torch.Tensor) -> Tuple[int, str]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}; one of {sorted(VARIANTS)}")
    if variant == "flash" and q.shape[-2] != k.shape[-2]:
        raise ValueError(f"variant 'flash' takes Sq == Skv, got {q.shape[-2]} and {k.shape[-2]}")
    return VARIANTS[variant]


def attention_variant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            variant: str) -> torch.Tensor:
    """The forward of one Pallas variant with its body's rounding points:
    f32 scores; ``v2`` / ``flash``: ``exp(s - max)``, ``v2_nomax``:
    ``exp(s)``, each over its f32 sum; ``fast`` / ``qblock``: ``exp2`` of the
    scores times ``scale * log2(e)``, times the reciprocal of the sum (exact
    here: the bodies' ``pl.reciprocal(approx=True)`` is a TPU approximation);
    ``fast_bf16sm``: the same on bf16 scores, ``e`` in bf16; all of them
    round P to q's dtype before ``P . v``. ``mmonly``: ``q . k^T`` rounded to
    q's dtype, times v (no scale, no softmax)."""
    mode = _variant(variant, q, k)[0]
    dt = q.dtype
    s = q.float() @ k.float().transpose(-1, -2)
    if mode == 5:
        p = s.to(dt)
    elif mode in _FAST_MODES:
        s = s * (scale * LOG2E)
        if mode == 4:
            e = torch.exp2(s.to(torch.bfloat16).float()).to(torch.bfloat16).float()
        else:
            e = torch.exp2(s)
        p = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(dt)
    else:
        s = s * scale
        if mode == 1:
            s = s - s.amax(dim=-1, keepdim=True)
        e = torch.exp(s)
        p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return (p.float() @ v.float()).to(dt)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX op's rematerialising VJP (``_bwd``): P recomputed in f32, f32
    products, dq, dk and dv each rounded once to its input's dtype. The JAX
    package leaves it to XLA, so it is PyTorch ops here on every device."""
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    p = _probs(q, k, scale)
    dp = g32 @ v32.transpose(-1, -2)
    dv = (p.transpose(-1, -2) @ g32).to(v.dtype)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = ((dl @ k32) * scale).to(q.dtype)
    dk = ((dl.transpose(-1, -2) @ q32) * scale).to(k.dtype)
    return dq, dk, dv


def _check_generic(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   name: str) -> Tuple[int, int, int, int, int]:
    """(B, H, Sq, Skv, hd) of what the generic kernel takes; raises on the
    device, dtype, shape, layout and head dim it does not take."""
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError(f"{name}: expected q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype} not supported "
                        "(all bf16 or all f32)")
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2]
            or q.shape[3] != k.shape[3]):
        raise ValueError(f"{name}: expected q (B, H, Sq, D) and k, v (B, H, Skv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    skv = k.shape[2]
    if min(b, h, sq, skv) < 1 or max(b, h) > 65535:
        raise ValueError(f"{name}: B {b}, H {h}, Sq {sq}, Skv {skv} outside the kernel's grid")
    max_hd = _lib().lct_attn_max_head_dim()
    if not 0 < hd <= max_hd:
        raise ValueError(f"{name}: head dim {hd} outside 1..{max_hd}")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim of q, k and v must be contiguous")
    return b, h, sq, skv, hd


def _generic_cuda(q, k, v, mode: int, mult: float, name: str) -> torch.Tensor:
    b, h, sq, skv, hd = _check_generic(q, k, v, name)
    out = torch.empty((b, h, sq, hd), dtype=q.dtype, device=q.device)
    err = _lib().lct_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], _DTYPES[q.dtype], mode,
        float(mult), _stream(q),
    )
    _raise_on(err, name)
    return out


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The generic forward kernel (P in f32): q, k, v read through their
    strides on B, H and S; a contiguous output."""
    out = _generic_cuda(q, k, v, 0, scale, "attention_cuda")
    LAUNCHES["attn_fwd"] += 1
    return out


def attention_variant_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                           variant: str) -> torch.Tensor:
    mode, key = _variant(variant, q, k)
    mult = scale * LOG2E if mode in _FAST_MODES else scale
    out = _generic_cuda(q, k, v, mode, mult, "attention_variant_cuda")
    LAUNCHES[key] += 1
    return out


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    if _route(q, "attention_forward") == "cuda":
        return attention_cuda(q, k, v, scale)
    return attention_plain(q, k, v, scale)


def attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      variant: str) -> torch.Tensor:
    """One Pallas variant's forward: its kernel mode on a CUDA tensor, its
    plain version on a CPU tensor."""
    if _route(q, "attention_variant") == "cuda":
        return attention_variant_cuda(q, k, v, scale, variant)
    return attention_variant_plain(q, k, v, scale, variant)


class _Attention(torch.autograd.Function):
    """Saves q, k and v only: the backward recomputes P, as the JAX op's
    custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return attention_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_bwd(q, k, v, g, ctx.scale), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, S, D) tensors (k and v may be
    longer or shorter than q along S), differentiable, with the
    rematerialising backward. ``scale=None`` is ``1/sqrt(D)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Attention.apply(q, k, v, float(scale))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """The generic op's entry point: the same function as
    :func:`fused_attention`. It differs from the JAX ``attention()``, which
    on a CPU autodiffs ``_xla_attention`` (P rounded to the input dtype
    before ``P . v``, and autodiff saves P) and takes the Pallas kernel only
    on a TPU with ``LIBCONTINUAL_ATTN=pallas``: here the forward keeps P in
    f32 on every device (the kernel on a CUDA tensor, its plain version on a
    CPU tensor), no environment switch is read, and the backward is always
    the rematerialising one (``LIBCONTINUAL_ATTN_VJP=remat`` in JAX)."""
    return fused_attention(q, k, v, scale)
