"""3x3 stride-1 SAME convolution as an implicit GEMM, forward and backward
(``libcontinual_tpu/ops/conv.py``).

``conv3x3(x, w)`` takes x NHWC ``(B, H, W, C)`` and w HWIO ``(3, 3, C, O)``
and returns ``(B, H, W, O)`` in x's dtype (w is cast to it, as a flax
``Conv(dtype=...)`` casts its kernel). Its backward is the JAX package's
``_conv3x3_bwd``: dx is the same convolution of the output gradient with the
taps rotated by 180 degrees and C and O swapped, dw the ``(9, C, O)`` f32
weight gradient, cast to w's dtype.

On a CUDA tensor the forward and the weight gradient are the hand-written
kernels of ``csrc/conv.cu`` (:func:`conv3x3_cuda`, :func:`conv3x3_dw_cuda`),
at any image size: the JAX package's VMEM gate (H, W >= 3 and H * W <= 4096)
is no limit of theirs. On a CPU tensor the plain versions run:
:func:`conv3x3_plain` is ``_fwd_kernel``'s arithmetic (9 tap-shifted
products, f32 sums, one rounding at the end) and :func:`conv3x3_dw_plain` is
``_dw_kernel``'s.

No model of the package calls this op: the port's ResNet keeps
``F.conv2d``, as the JAX ResNet keeps ``nn.Conv``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

#: kernel launches per wrapper; a launch adds one here and nowhere else (the
#: weight gradient's two CUDA launches, partial sums and their reduction, are
#: one launch of the dw kernel)
LAUNCHES: Dict[str, int] = {"conv3x3_fwd": 0, "conv3x3_dw": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rotate_taps(w: torch.Tensor) -> torch.Tensor:
    """The taps of dx: HWIO rotated by 180 degrees with C and O swapped,
    ``(3, 3, O, C)``."""
    return torch.flip(w, (0, 1)).transpose(2, 3)


def _shifted(x: torch.Tensor):
    """The 9 tap-shifted views ``(B*H*W, C)`` in f32 of the zero-padded x,
    tap = dh * 3 + dw."""
    b, h, wd, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return [xp[:, dh:dh + h, dw:dw + wd, :].reshape(-1, c) for dh in range(3) for dw in range(3)]


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward as ``_fwd_kernel`` computes it: the sum over the 9 taps of
    the shifted x times the tap's ``(C, O)`` weights, in f32, rounded once to
    x's dtype."""
    b, h, wd, _ = x.shape
    w9 = w.reshape(9, w.shape[2], w.shape[3]).float()
    acc = None
    for tap, xs in enumerate(_shifted(x)):
        prod = xs @ w9[tap]
        acc = prod if acc is None else acc + prod
    return acc.to(x.dtype).reshape(b, h, wd, w.shape[3])


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient as ``_dw_kernel`` computes it: ``(9, C, O)`` f32,
    each tap's shifted x transposed times g over all B*H*W pixels."""
    g2 = g.reshape(-1, g.shape[-1]).float()
    return torch.stack([xs.T @ g2 for xs in _shifted(x)])


# ------------------------------------------------------------------ kernels


def _lib() -> ctypes.CDLL:
    from libcontinual_tpu_torch.ops import _build

    return _build.lib("conv")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _check(x: torch.Tensor, name: str) -> Tuple[int, int, int, int]:
    """(B, H, W, C) of an NHWC tensor the kernels take; raises on the device,
    dtype, layout and shape they do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (bf16 or f32)")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, W, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous NHWC")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    return tuple(x.shape)


def _check_like(t: torch.Tensor, ref: torch.Tensor, shape, what: str, name: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype} on {t.device} does not "
                         f"match {tuple(shape)} {ref.dtype} on {ref.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3_fwd_kernel``: x ``(B, H, W, C)``, w ``(3, 3, C, O)`` or its
    taps ``(9, C, O)`` in x's dtype -> ``(B, H, W, O)``."""
    name = "conv3x3_cuda"
    b, h, wd, c = _check(x, name)
    o = w.shape[-1]
    _check_like(w, x, (3, 3, c, o) if w.dim() == 4 else (9, c, o), "weight", name)
    y = torch.empty((b, h, wd, o), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().lct_conv3x3_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, o,
                                 _DTYPES[x.dtype], stream)
    _raise_on(err, name)
    LAUNCHES["conv3x3_fwd"] += 1
    return y


def conv3x3_dw_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``conv3x3_dw_partial_kernel`` and ``conv3x3_dw_reduce_kernel``: x
    ``(B, H, W, C)`` and g ``(B, H, W, O)`` -> the ``(9, C, O)`` f32 weight
    gradient."""
    name = "conv3x3_dw_cuda"
    b, h, wd, c = _check(x, name)
    o = g.shape[-1]
    _check_like(g, x, (b, h, wd, o), "gradient", name)
    lib = _lib()
    slices = lib.lct_conv3x3_dw_slices(b, h, wd, c, o)
    partial = torch.empty((slices, 9, c, o), dtype=torch.float32, device=x.device)
    dw = torch.empty((9, c, o), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lct_conv3x3_dw(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                             b, h, wd, c, o, _DTYPES[x.dtype], stream)
    _raise_on(err, name)
    LAUNCHES["conv3x3_dw"] += 1
    return dw


# ---------------------------------------------------------------- dispatch


def _use_kernels(x: torch.Tensor, name: str) -> bool:
    """The kernels on a CUDA tensor, the plain versions on a CPU tensor; any
    other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no implementation for device {x.device}")
    return True


def conv3x3_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if _use_kernels(x, "conv3x3_forward"):
        return conv3x3_cuda(x, w)
    return conv3x3_plain(x, w)


def conv3x3_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if _use_kernels(x, "conv3x3_weight_grad"):
        return conv3x3_dw_cuda(x, g)
    return conv3x3_dw_plain(x, g)


class _Conv3x3(torch.autograd.Function):
    """Saves x and the cast weights; the backward is ``_conv3x3_bwd``."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        wc = w.to(x.dtype).contiguous()
        ctx.save_for_backward(x, wc)
        ctx.w_dtype = w.dtype
        return conv3x3_forward(x, wc)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_forward(g, rotate_taps(wc).contiguous())
        dw = conv3x3_weight_grad(x, g).reshape(wc.shape)
        return dx, dw.to(ctx.w_dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution, NHWC x ``(B, H, W, C)`` with HWIO w
    ``(3, 3, C, O)`` -> ``(B, H, W, O)`` in x's dtype, differentiable."""
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    return _Conv3x3.apply(x, w)
