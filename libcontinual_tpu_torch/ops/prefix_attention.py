"""Prefix-KV self-attention for the prompt family (DualPrompt, CODA-Prompt).

Counterpart of ``fused_prefix_attention`` in
``libcontinual_tpu/ops/attention.py``: ``(B, S, 3D)`` qkv laid out as
``[q | k | v]`` and per-image prompt keys and values ``pk``, ``pv`` of shape
``(B, P, D)`` -> ``(B, S, D)``. Each query attends to the P prompt rows and
the S sequence rows under one softmax. On a CUDA tensor the forward and
backward are the hand-written kernels of ``csrc/attention.cu``; on a
CPU tensor they are the plain PyTorch versions below, which keep the TPU
kernel bodies' rounding points: two score blocks with one max and one
denominator, the probabilities cast to the input dtype before the ``. pv``
and ``. v`` products, and in the backward ``dlp`` and ``dlx`` cast before the
products. Any other device raises.

``pk`` and ``pv`` may be views: the kernels take any batch stride (0 for a
prompt broadcast over the batch) as long as each image's rows are
contiguous. Their gradients are always per image, ``(B, P, D)``.

This is the ``prefix`` mode of the packed-qkv op of ``ops/attention.py``,
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


def _prefix_heads(p: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = p.shape
    return p.reshape(b, n, heads, d // heads).transpose(1, 2)  # (B, H, P, hd)


def _prefix_probs(q, k, pk, scale):
    """Both probability blocks in f32: (B, H, S, P) and (B, H, S, S)."""
    sp = (q.float() @ pk.float().transpose(-1, -2)) * scale
    sx = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = torch.maximum(sp.amax(dim=-1, keepdim=True), sx.amax(dim=-1, keepdim=True))
    ep, ex = torch.exp(sp - m), torch.exp(sx - m)
    den = ep.sum(dim=-1, keepdim=True) + ex.sum(dim=-1, keepdim=True)
    return ep / den, ex / den


def prefix_attention_plain(
    qkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """The forward as the TPU kernel body computes it, in plain PyTorch."""
    b, s, d3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, heads)
    pkh, pvh = _prefix_heads(pk, heads), _prefix_heads(pv, heads)
    pp, px = _prefix_probs(q, k, pkh, scale)
    o = pp.to(dt).float() @ pvh.float() + px.to(dt).float() @ v.float()
    return o.to(dt).transpose(1, 2).reshape(b, s, d3 // 3)


def prefix_attention_bwd_plain(
    qkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor, g: torch.Tensor,
    scale: float, heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as the TPU kernel body computes it: packed ``dqkv``,
    and ``dpk``, ``dpv`` per image."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    p = pk.shape[1]
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, heads)
    pkh, pvh = _prefix_heads(pk, heads), _prefix_heads(pv, heads)
    gh = g.reshape(b, s, heads, d // heads).transpose(1, 2).float()
    pp, px = _prefix_probs(q, k, pkh, scale)
    dpp = gh @ pvh.float().transpose(-1, -2)
    dpx = gh @ v.float().transpose(-1, -2)
    c = (dpp * pp).sum(dim=-1, keepdim=True) + (dpx * px).sum(dim=-1, keepdim=True)
    dlp = (pp * (dpp - c)).to(dt).float()
    dlx = (px * (dpx - c)).to(dt).float()
    qf = q.float()
    dq = (dlp @ pkh.float() + dlx @ k.float()) * scale
    dk = (dlx.transpose(-1, -2) @ qf) * scale
    dv = px.to(dt).float().transpose(-1, -2) @ gh
    dpk = (dlp.transpose(-1, -2) @ qf) * scale
    dpv = pp.to(dt).float().transpose(-1, -2) @ gh

    def packed(t, n):
        return t.to(dt).transpose(1, 2).reshape(b, n, d)

    dqkv = torch.cat([packed(dq, s), packed(dk, s), packed(dv, s)], dim=-1)
    return dqkv, packed(dpk, p), packed(dpv, p)


# ------------------------------------------------------------------ kernels


def _prefix_rows(t: torch.Tensor, like: torch.Tensor, b: int, d: int, name: str) -> torch.Tensor:
    """``t`` as the kernel reads it: (B, P, D) with each image's rows
    contiguous; any batch stride stays (a broadcast prompt is not copied)."""
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: prefix {t.dtype} on {t.device} does not match qkv {like.dtype} "
            f"on {like.device}"
        )
    if t.dim() != 3 or t.shape[0] != b or t.shape[2] != d:
        raise ValueError(f"{name}: expected a ({b}, P, {d}) prefix, got {tuple(t.shape)}")
    if t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != d):
        t = t.contiguous()
    return t


def _check(qkv, pk, pv, heads: int, name: str):
    b, s, d, hd = _check_packed(qkv, heads, name)
    pk = _prefix_rows(pk, qkv, b, d, name)
    pv = _prefix_rows(pv, qkv, b, d, name)
    p = pk.shape[1]
    if pv.shape[1] != p or p < 1:
        raise ValueError(f"{name}: pk has {p} rows and pv {pv.shape[1]}; need the same, >= 1")
    return pk, pv, (b, s, p, d, hd)


def prefix_attention_cuda(
    qkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    pk, pv, (b, s, p, d, hd) = _check(qkv, pk, pv, heads, "prefix_attention_cuda")
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    err = _lib().lct_pqkv_fwd(
        qkv.data_ptr(), pk.data_ptr(), pv.data_ptr(), pk.stride(0), pv.stride(0),
        out.data_ptr(), b, s, p, heads, hd, _DTYPES[qkv.dtype], float(scale), _stream(qkv),
    )
    _raise_on(err, "prefix_attention_cuda")
    _launched("pqkv_fwd", (b, s, p, d, int(heads)), p + s, hd, qkv.dtype)
    return out


def prefix_attention_bwd_cuda(
    qkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor, g: torch.Tensor,
    scale: float, heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pk, pv, (b, s, p, d, hd) = _check(qkv, pk, pv, heads, "prefix_attention_bwd_cuda")
    g = _check_grad(g, qkv, b, s, d, "prefix_attention_bwd_cuda")
    dqkv = torch.empty_like(qkv)
    dpk = torch.empty((b, p, d), dtype=qkv.dtype, device=qkv.device)
    dpv = torch.empty_like(dpk)
    stats = torch.empty((3, b, heads, s), dtype=torch.float32, device=qkv.device)
    err = _lib().lct_pqkv_bwd(
        qkv.data_ptr(), pk.data_ptr(), pv.data_ptr(), pk.stride(0), pv.stride(0),
        g.data_ptr(), dqkv.data_ptr(), dpk.data_ptr(), dpv.data_ptr(), stats.data_ptr(),
        b, s, p, heads, hd, _DTYPES[qkv.dtype], float(scale), _stream(qkv),
    )
    _raise_on(err, "prefix_attention_bwd_cuda")
    _launched("pqkv_bwd", (b, s, p, d, int(heads)), p + s, hd, qkv.dtype)
    return dqkv, dpk, dpv


def fused_prefix_attention(
    qkv: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor, scale: float, heads: int
) -> torch.Tensor:
    """Prefix-KV self-attention straight off the packed qkv tensor:
    ``(B, S, 3D), (B, P, D), (B, P, D) -> (B, S, D)``, differentiable in all
    three inputs."""
    return _packed_attention("prefix", qkv, scale, heads, pk, pv)
