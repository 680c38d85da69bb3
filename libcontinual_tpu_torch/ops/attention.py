"""Packed-qkv self-attention for the ViT stack.

Counterpart of ``fused_qkv_attention`` in ``libcontinual_tpu/ops/attention.py``:
``(B, S, 3D)`` qkv laid out as ``[q | k | v]`` -> ``(B, S, D)``, with the
head split done inside the kernel. On a CUDA tensor the forward and backward
are the hand-written kernels of ``csrc/attention.cu``; on a CPU tensor
they are the plain PyTorch versions below, which keep the TPU kernel bodies'
rounding points (P cast to the input dtype before ``P . v``; at bf16, dS cast
before the dq/dk products). Any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

#: kernel launches per wrapper; a launch adds one here and nowhere else
LAUNCHES: Dict[str, int] = {"qkv_fwd": 0, "qkv_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)


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
    the device, dtype, layout and head dim they do not take."""
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
    if d % heads != 0 or d // heads not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}/{heads} not in {_HEAD_DIMS}")
    return b, s, d, d // heads


def _check(qkv: torch.Tensor, heads: int, name: str) -> Tuple[int, int, int, int]:
    b, s, d, hd = _check_packed(qkv, heads, name)
    max_s = _lib().lct_qkv_max_seq()
    if not 0 < s <= max_s:
        raise ValueError(f"{name}: sequence length {s} outside 1..{max_s}")
    return b, s, d, hd


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def qkv_attention_cuda(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    b, s, d, hd = _check(qkv, heads, "qkv_attention_cuda")
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _lib().lct_qkv_fwd(
        qkv.data_ptr(), out.data_ptr(), b, s, heads, hd, _DTYPES[qkv.dtype],
        float(scale), stream,
    )
    _raise_on(err, "qkv_attention_cuda")
    LAUNCHES["qkv_fwd"] += 1
    return out


def qkv_attention_bwd_cuda(
    qkv: torch.Tensor, g: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    b, s, d, hd = _check(qkv, heads, "qkv_attention_bwd_cuda")
    g = g.contiguous()
    if g.shape != (b, s, d) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(
            f"qkv_attention_bwd_cuda: gradient {tuple(g.shape)} {g.dtype} on "
            f"{g.device} does not match qkv {tuple(qkv.shape)} {qkv.dtype}"
        )
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, s), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _lib().lct_qkv_bwd(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, s, heads, hd, _DTYPES[qkv.dtype], float(scale), stream,
    )
    _raise_on(err, "qkv_attention_bwd_cuda")
    LAUNCHES["qkv_bwd"] += 1
    return dqkv


# ---------------------------------------------------------------- dispatch


def _route(t: torch.Tensor, name: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: no implementation for device {t.device}")


def qkv_attention_forward(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    if _route(qkv, "qkv_attention_forward") == "cuda":
        return qkv_attention_cuda(qkv, scale, heads)
    return qkv_attention_plain(qkv, scale, heads)


def qkv_attention_backward(
    qkv: torch.Tensor, g: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    if _route(qkv, "qkv_attention_backward") == "cuda":
        return qkv_attention_bwd_cuda(qkv, g, scale, heads)
    return qkv_attention_bwd_plain(qkv, g, scale, heads)


class _FusedQKVAttention(torch.autograd.Function):
    """Saves only qkv: the backward recomputes the probabilities, as
    ``_qkv_attention_core``'s custom VJP does."""

    @staticmethod
    def forward(ctx, qkv, scale, heads):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.heads = scale, heads
        return qkv_attention_forward(qkv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return qkv_attention_backward(qkv, g, ctx.scale, ctx.heads), None, None


def fused_qkv_attention(qkv: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """Self-attention straight off the packed qkv tensor:
    ``(B, S, 3D) -> (B, S, D)``, differentiable."""
    return _FusedQKVAttention.apply(qkv, float(scale), int(heads))
