"""The port's 3x3 convolution against the JAX package: the plain PyTorch
forward, dx and weight gradient (what a CPU tensor runs), and the autograd
function, against the JAX ``conv3x3`` with its Pallas bodies ``_fwd_kernel``
/ ``_dw_kernel`` run by the interpreter (``LIBCONTINUAL_CONV=fused``, as
``tests/test_ops.py`` runs them) and against ``_xla_conv3x3`` and its
autodiff; a bf16 forward; and images outside the JAX package's shape gate,
which the port takes whole."""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu_torch.ops import conv as T  # noqa: E402

J = importlib.import_module("libcontinual_tpu.ops.conv")

#: float32: the same products summed in another order (test_ops.py's bound)
F32_TOL = 1e-4
#: bfloat16 output: identical rounding points, so a sum-order difference can
#: flip one rounding: one bf16 ulp (2^-7 relative) at the largest magnitude
BF16_REL = 2.0 ** -7

# (B, H, W, C, O): odd sizes, the CIFAR stem's C 3, the AML widths, a 4x4 image;
# then the card kernels' tile edges: C and O of 16, 17 and 65 (one past the
# 16-channel mma tile and the 64-channel block tile), pixel rows that are no
# whole 16-byte chunks (C 5: 10 bytes in bf16) in 3x3 images, each smaller
# than one 16-pixel mma tile; a row wider than the forward's 128-pixel tile
# (W 200), and O 3 (dx at the CIFAR stem writes 3 channels)
SHAPES = [(3, 5, 7, 3, 8), (2, 6, 5, 20, 24), (2, 4, 4, 20, 40), (1, 3, 9, 16, 16),
          (2, 5, 7, 16, 17), (1, 3, 4, 17, 65), (1, 4, 3, 65, 16), (3, 3, 3, 5, 17),
          (1, 3, 200, 8, 8), (2, 7, 7, 16, 3)]


def _inputs(b, h, w, c, o, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)
    g = rng.randn(b, h, w, o).astype(np.float32)
    return x, k, g


def _jax_conv(x, k, g):
    """(y, dx, dw) of the JAX ``conv3x3`` and its custom VJP."""
    y, vjp = jax.vjp(J.conv3x3, jnp.asarray(x), jnp.asarray(k))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _close(a, b, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_bodies(shape, monkeypatch):
    monkeypatch.setenv("LIBCONTINUAL_CONV", "fused")
    x, k, g = _inputs(*shape)
    assert J.conv3x3_ok(x.shape)
    jy, jdx, jdw = _jax_conv(x, k, g)
    tx, tk, tg = (torch.from_numpy(a) for a in (x, k, g))
    _close(T.conv3x3_plain(tx, tk), jy)
    _close(T.conv3x3_plain(tg, T.rotate_taps(tk)), jdx)
    _close(T.conv3x3_dw_plain(tx, tg).reshape(k.shape), jdw)
    # the dw body alone, (9, C, O) f32
    _close(T.conv3x3_dw_plain(tx, tg), np.asarray(J._pallas_conv3x3_dw(jnp.asarray(x),
                                                                        jnp.asarray(g))))


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_matches_xla_conv(shape, monkeypatch):
    monkeypatch.delenv("LIBCONTINUAL_CONV", raising=False)
    x, k, g = _inputs(*shape, seed=1)
    y, vjp = jax.vjp(J._xla_conv3x3, jnp.asarray(x), jnp.asarray(k))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    T.reset_launches()
    out = T.conv3x3(tx, tk)
    out.backward(torch.from_numpy(g))
    assert T.LAUNCHES == {"conv3x3_fwd": 0, "conv3x3_dw": 0}  # the CPU runs no kernel
    _close(out.detach(), y)
    _close(tx.grad, jdx)
    _close(tk.grad, jdw)


def test_bf16_forward_matches_pallas_body(monkeypatch):
    monkeypatch.setenv("LIBCONTINUAL_CONV", "fused")
    x, k, _ = _inputs(2, 8, 8, 16, 32, seed=2)
    jy = np.asarray(J.conv3x3(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)))
    ty = T.conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert ty.dtype == torch.bfloat16
    ref = jy.astype(np.float32)
    _close(ty.float(), ref, tol=BF16_REL * float(np.abs(ref).max()))


def test_weights_are_cast_to_the_input_dtype():
    x, k, g = _inputs(2, 5, 5, 4, 6, seed=3)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()  # f32 weights, bf16 activations
    y = T.conv3x3(tx, tk)
    y.float().backward(torch.from_numpy(g))
    assert y.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16
    assert tk.grad.dtype == torch.float32
    torch.testing.assert_close(y, T.conv3x3_plain(tx.detach(), tk.detach().bfloat16()))


@pytest.mark.parametrize("hw", [(1, 1), (2, 8), (8, 2), (1, 9), (65, 64), (40, 110)])
def test_outside_the_tpu_gate_matches_xla_conv(hw, monkeypatch):
    """Images the JAX op sends to XLA (H or W < 3, H * W > 4096): the port
    has no such gate, and its y, dx and dw still match XLA's."""
    monkeypatch.setenv("LIBCONTINUAL_CONV", "fused")
    assert not J.conv3x3_ok((2, *hw, 4))
    x, k, g = _inputs(2, *hw, 4, 5, seed=4)
    y, vjp = jax.vjp(J.conv3x3, jnp.asarray(x), jnp.asarray(k))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    out = T.conv3x3(tx, tk)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), y)
    _close(tx.grad, jdx)
    # dw sums up to 8320 products a tap: the f32 bound relative to its largest
    # magnitude
    _close(tk.grad, jdw, tol=F32_TOL * max(1.0, float(np.abs(jdw).max())))


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        T.conv3x3_cuda(x, torch.zeros(3, 3, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        T.conv3x3_dw_cuda(x, torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError, match="do not match"):
        T.conv3x3(x, torch.zeros(3, 3, 4, 8))
