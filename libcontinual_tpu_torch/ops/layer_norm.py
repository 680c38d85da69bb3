"""LayerNorm over the last axis, with f32 statistics and arithmetic and one
rounding to the caller's dtype: flax ``LayerNorm(dtype=...)``, as the ViT
and CLIP towers of ``libcontinual_tpu/models/vit.py`` use it.

``layer_norm(x, weight, bias, eps, dtype)`` takes x ``(..., D)`` in bf16 or
f32 and the parameters ``(D,)`` in bf16 or f32, and returns ``(..., D)`` in
``dtype``. On a CUDA tensor the forward and backward are the hand-written
kernels of ``csrc/layer_norm.cu`` (:func:`layer_norm_cuda`,
:func:`layer_norm_bwd_cuda`), which read and write the activations in their
own dtype. On a CPU tensor the op is :func:`layer_norm_plain`, the port's
composition ``F.layer_norm(x.float(), ...).to(dtype)`` bit for bit, with its
autograd. Any other device raises; so does a D that the kernels do not take
(a multiple of 8 up to :data:`MAX_DIM`), on every device.

Both keep the same rounding points: x converted to f32 exactly, the mean,
the variance about it and the normalised row in f32, one rounding of y to
``dtype``; in the backward one rounding of dx to x's dtype, and dw and db
summed in f32 and rounded once to the parameters' dtype.
:func:`layer_norm_bwd_plain` writes the kernel's backward equations in
PyTorch; the kernels differ from the plain versions only in the order of
the f32 sums.

The JAX package has no LayerNorm kernel: XLA fuses the casts around flax's
LayerNorm. So this op replaces no TPU kernel; it replaces the cast, f32
LayerNorm and cast launches that eager PyTorch makes of the composition.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from libcontinual_tpu_torch.utils.trace import TRACER

#: kernel launches per wrapper (a backward that sums dw and db is one launch)
LAUNCHES: Dict[str, int] = {"ln_fwd": 0, "ln_bwd": 0}
#: the widest row the kernels take (``kLnMaxDim`` in ``csrc/layer_norm.cu``);
#: D must also be a multiple of 8 (16-byte chunks of bf16)
MAX_DIM = 4096

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """The forward in PyTorch ops: computed in f32, the result in ``dtype``."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(dtype)


def layer_norm_stats_plain(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row statistics the forward kernel saves: the f32 mean and ``1 /
    sqrt(var + eps)`` with the variance about the mean, each ``x.shape[:-1]``."""
    x32 = x.float()
    mean = x32.mean(dim=-1)
    var = (x32 - mean[..., None]).square().mean(dim=-1)
    return mean, 1.0 / torch.sqrt(var + eps)


def layer_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's equations: ``xhat = (x - mean) * rstd``, ``wdy =
    g * w``, ``dx = rstd * (wdy - xhat * mean(wdy * xhat) - mean(wdy))``
    rounded to x's dtype, and the f32 ``dw = sum(g * xhat)`` and ``db =
    sum(g)`` over every row."""
    mean, rstd = layer_norm_stats_plain(x, eps)
    mean, rstd = mean[..., None], rstd[..., None]
    g32 = g.float()
    xhat = (x.float() - mean) * rstd
    wdy = g32 * weight.float()
    a = (wdy * xhat).mean(dim=-1, keepdim=True)
    b = wdy.mean(dim=-1, keepdim=True)
    dx = (rstd * (wdy - xhat * a - b)).to(x.dtype)
    d = x.shape[-1]
    return dx, (g32 * xhat).reshape(-1, d).sum(dim=0), g32.reshape(-1, d).sum(dim=0)


# ------------------------------------------------------------------ kernels


def _lib() -> ctypes.CDLL:
    from libcontinual_tpu_torch.ops import _build

    return _build.lib("layer_norm")


def _check_dim(d: int, name: str) -> None:
    if d % 8 != 0 or not 0 < d <= MAX_DIM:
        raise ValueError(f"{name}: D {d} not supported (a multiple of 8 up to {MAX_DIM})")


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           name: str) -> Tuple[int, int]:
    """(rows, D) of an input the kernels take; raises on the device, dtype,
    layout and shape they do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (bf16 or f32)")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    d = x.shape[-1]
    _check_dim(d, name)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be contiguous and 16-byte aligned")
    for what, p in (("weight", weight), ("bias", bias)):
        if p is None:
            continue
        if p.shape != (d,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: {what} {tuple(p.shape)} on {p.device} does not match "
                             f"D {d} on {x.device}")
        if p.dtype != weight.dtype or p.dtype not in _DTYPES:
            raise TypeError(f"{name}: {what} dtype {p.dtype} not supported (bf16 or f32, "
                            "the same for weight and bias)")
    return x.numel() // d, d


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    dtype: torch.dtype, stats: bool = False):
    """``ln_fwd_kernel``: y in ``dtype``, shaped as x; with ``stats`` also
    the f32 row mean and rstd the backward reads, else ``None`` for both."""
    name = "layer_norm_cuda"
    rows, d = _check(x, weight, bias, name)
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: output dtype {dtype} not supported (bf16 or f32)")
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    err = _lib().lct_ln_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None,
        rows, d, _DTYPES[x.dtype], _DTYPES[dtype], _DTYPES[weight.dtype], float(eps),
        _stream(x),
    )
    _raise_on(err, name)
    LAUNCHES["ln_fwd"] += 1
    TRACER.launch("ln_fwd", (rows, d))
    return y, mean, rstd


def layer_norm_bwd_cuda(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor, dx: bool = True,
                        params: bool = False):
    """``ln_bwd_kernel`` (and with ``params`` ``ln_bwd_reduce_kernel``): from
    x, the output gradient g (contiguous, shaped as x, in the forward
    output's dtype), the weight and the forward's mean and rstd, dx in x's
    dtype (``None`` without ``dx``) and, with ``params``, dw and db in the
    weight's dtype (else ``None`` for both)."""
    name = "layer_norm_bwd_cuda"
    rows, d = _check(x, weight, None, name)
    if (g.shape != x.shape or g.device != x.device or g.dtype not in _DTYPES
            or not g.is_contiguous() or g.data_ptr() % 16):
        raise ValueError(f"{name}: gradient {tuple(g.shape)} {g.dtype} on {g.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}, or is not contiguous")
    for what, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != x.shape[:-1] or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype} does not match the "
                             f"rows {tuple(x.shape[:-1])} in f32")
    if not (dx or params):
        raise ValueError(f"{name}: nothing to compute")
    lib = _lib()
    grad_x = torch.empty_like(x) if dx else None
    partial = dw = db = None
    if params:
        partial = torch.empty((lib.lct_ln_bwd_parts(rows), 2 * d), dtype=torch.float32,
                              device=x.device)
        dw = torch.empty_like(weight)
        db = torch.empty_like(weight)
    err = lib.lct_ln_bwd(
        x.data_ptr(), g.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (grad_x, partial, dw, db)),
        rows, d, _DTYPES[x.dtype],
        _DTYPES[g.dtype], _DTYPES[weight.dtype], _stream(x),
    )
    _raise_on(err, name)
    LAUNCHES["ln_bwd"] += 1
    TRACER.launch("ln_bwd", (rows, d))
    return grad_x, dw, db


# ---------------------------------------------------------------- dispatch


class _LayerNorm(torch.autograd.Function):
    """Saves x as it came in (no copy), the weight and the f32 row mean and
    rstd; the backward computes only the gradients asked for."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        y, mean, rstd = layer_norm_cuda(x, weight, bias, eps, dtype, stats=True)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, rstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = layer_norm_bwd_cuda(x, g.contiguous(), weight, mean, rstd, dx=need_x,
                                         params=need_w or need_b)
        return dx, dw if need_w else None, db if need_b else None, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of x over its last axis with f32 statistics, the result in
    ``dtype``, differentiable: the kernels on a CUDA tensor (through an
    autograd node only when a gradient is wanted), :func:`layer_norm_plain`
    on a CPU tensor."""
    name = "layer_norm"
    _check_dim(x.shape[-1], name)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no implementation for device {x.device}")
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, float(eps), dtype)
    return layer_norm_cuda(x, weight, bias, eps, dtype)[0]
