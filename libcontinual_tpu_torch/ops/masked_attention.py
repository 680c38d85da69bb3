"""Additive-mask self-attention for the CLIP text tower.

Counterpart of ``fused_masked_qkv_attention`` in
``libcontinual_tpu/ops/attention.py``: ``(B, S, 3D)`` qkv laid out as
``[q | k | v]`` and a ``(S, S)`` float32 mask shared by every image and head
(the causal ``-1e30`` mask) -> ``(B, S, D)``. The mask is added to the scores
and gets no gradient. On a CUDA tensor the forward and backward are the
hand-written kernels of ``csrc/attention.cu``; on a CPU tensor they are the
plain PyTorch versions below, which keep the TPU kernel bodies' rounding
points: ``s = (q . k^T in f32) * scale + mask``, P cast to the input dtype
before ``P . v``, and in the backward dS cast before the dq/dk products. Any
other device raises.

This is the ``masked`` mode of the packed-qkv op of ``ops/attention.py``,
whose autograd node routes by device and whose ``LAUNCHES`` (imported here)
counts the launches; this module holds the mode's plain versions, input
checks and kernel wrappers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from libcontinual_tpu_torch.ops.attention import (  # noqa: F401 (LAUNCHES)
    LAUNCHES,
    _DTYPES,
    _check_grad,
    _check_packed,
    _launched,
    _lib,
    _packed_attention,
    _raise_on,
    _split_heads,
    _stream,
)


def _masked_probs(q, k, mask, scale) -> torch.Tensor:
    s = (q.float() @ k.float().transpose(-1, -2)) * scale + mask.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)  # f32


def masked_attention_plain(
    qkv: torch.Tensor, mask: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """The forward as the TPU kernel body computes it, in plain PyTorch."""
    b, s, d3 = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    p = _masked_probs(q, k, mask, scale).to(qkv.dtype)
    o = (p.float() @ v.float()).to(qkv.dtype)  # (B, H, S, hd)
    return o.transpose(1, 2).reshape(b, s, d3 // 3)


def masked_attention_bwd_plain(
    qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """The backward as the TPU kernel body computes it: packed ``dqkv``."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, heads)
    gh = g.reshape(b, s, heads, d // heads).transpose(1, 2).float()
    p = _masked_probs(q, k, mask, scale)
    dp = gh @ v.float().transpose(-1, -2)
    dv = p.to(dt).float().transpose(-1, -2) @ gh
    dl = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = (dl @ k.float()) * scale
    dk = (dl.transpose(-1, -2) @ q.float()) * scale
    parts = [t.to(dt).transpose(1, 2).reshape(b, s, d) for t in (dq, dk, dv)]
    return torch.cat(parts, dim=-1)


# ------------------------------------------------------------------ kernels


def _check(qkv: torch.Tensor, mask: torch.Tensor, heads: int, name: str) -> Tuple[int, int, int, int]:
    b, s, d, hd = _check_packed(qkv, heads, name)
    if mask.dtype != torch.float32:
        raise TypeError(f"{name}: mask dtype {mask.dtype}, expected float32")
    if tuple(mask.shape) != (s, s) or mask.device != qkv.device:
        raise ValueError(
            f"{name}: expected a ({s}, {s}) mask on {qkv.device}, got "
            f"{tuple(mask.shape)} on {mask.device}"
        )
    if not mask.is_contiguous():
        raise ValueError(f"{name}: mask must be contiguous")
    return b, s, d, hd


def masked_attention_cuda(
    qkv: torch.Tensor, mask: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    b, s, d, hd = _check(qkv, mask, heads, "masked_attention_cuda")
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    err = _lib().lct_mqkv_fwd(
        qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), b, s, heads, hd,
        _DTYPES[qkv.dtype], float(scale), _stream(qkv),
    )
    _raise_on(err, "masked_attention_cuda")
    _launched("mqkv_fwd", (b, s, d, int(heads)), s, hd, qkv.dtype)
    return out


def masked_attention_bwd_cuda(
    qkv: torch.Tensor, mask: torch.Tensor, g: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    b, s, d, hd = _check(qkv, mask, heads, "masked_attention_bwd_cuda")
    g = _check_grad(g, qkv, b, s, d, "masked_attention_bwd_cuda")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, heads, s), dtype=torch.float32, device=qkv.device)
    err = _lib().lct_mqkv_bwd(
        qkv.data_ptr(), mask.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, s, heads, hd, _DTYPES[qkv.dtype], float(scale), _stream(qkv),
    )
    _raise_on(err, "masked_attention_bwd_cuda")
    _launched("mqkv_bwd", (b, s, d, int(heads)), s, hd, qkv.dtype)
    return dqkv


def fused_masked_qkv_attention(
    qkv: torch.Tensor, mask: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """Additive-mask self-attention straight off the packed qkv tensor:
    ``(B, S, 3D), (S, S) -> (B, S, D)``, differentiable in qkv."""
    return _packed_attention("masked", qkv, scale, heads, mask)
