"""The port's packed-qkv attention against the JAX package: the plain
PyTorch forward and backward (what a CPU tensor runs) against
``fused_qkv_attention`` with ``jax.vjp``, and against the Pallas kernel
bodies ``_qkv_kernel`` / ``_qkv_bwd_kernel`` run in interpret mode."""

from __future__ import annotations

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

torch.set_num_threads(1)

from libcontinual_tpu_torch.ops import attention as T  # noqa: E402

A = importlib.import_module("libcontinual_tpu.ops.attention")

#: float32: the same arithmetic, summed in another order
F32_TOL = 1e-5
#: bfloat16: identical rounding points, so only a sum-order difference that
#: flips one bf16 rounding can show: two bf16 ulps at magnitude 2 (outputs
#: here stay below 2.5)
BF16_TOL = 1.6e-2

SHAPES = [(2, 13, 4, 16), (1, 17, 2, 32), (2, 9, 1, 64)]  # (B, S, H, hd)
# past the 256 keys and the 16/32/64 head dims of the port's first kernels:
# S 300 at hd 128, S 260 at hd 48 (no power of two)
LONG_SHAPES = [(1, 300, 2, 128), (1, 260, 1, 48)]
# the edges of the CUDA kernels' tiles at hd 64: a warp's 16 rows and a
# block's 64 (S 16, 64, 65, 128)
EDGE_SHAPES = [(1, 16, 1, 64), (1, 64, 1, 64), (1, 65, 1, 64), (1, 128, 1, 64)]
SHAPES += LONG_SHAPES + EDGE_SHAPES


def _inputs(b, s, h, hd, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * h * hd).astype(np.float32)
    g = rng.randn(b, s, h * hd).astype(np.float32)
    return qkv, g


def _pallas_fwd(qkv, scale, heads):
    b, s, d3 = qkv.shape
    return pl.pallas_call(
        functools.partial(A._qkv_kernel, scale=scale, heads=heads, bt=1),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, s, d3 // 3), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, s, d3 // 3), qkv.dtype),
        interpret=True,
    )(qkv)


def _pallas_bwd(qkv, g, scale, heads):
    b, s, d3 = qkv.shape
    return pl.pallas_call(
        functools.partial(A._qkv_bwd_kernel, scale=scale, heads=heads, bt=1),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, s, d3 // 3), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, s, d3), qkv.dtype),
        interpret=True,
    )(qkv, g)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_vjp_match_jax(shape):
    b, s, h, hd = shape
    qkv, g = _inputs(*shape)
    scale = 1.0 / np.sqrt(hd)
    out_j, vjp = jax.vjp(lambda x: A.fused_qkv_attention(x, scale, h), jnp.asarray(qkv))
    (dqkv_j,) = vjp(jnp.asarray(g))

    x = torch.from_numpy(qkv).requires_grad_()
    out_t = T.fused_qkv_attention(x, scale, h)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dqkv_j), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_pallas_bodies_f32(shape):
    b, s, h, hd = shape
    qkv, g = _inputs(*shape, seed=1)
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(jnp.asarray(qkv), scale, h))
    dqkv_p = np.asarray(_pallas_bwd(jnp.asarray(qkv), jnp.asarray(g), scale, h))
    out_t = T.qkv_attention_plain(torch.from_numpy(qkv), scale, h)
    dqkv_t = T.qkv_attention_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(g), scale, h)
    np.testing.assert_allclose(out_t.numpy(), out_p, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(dqkv_t.numpy(), dqkv_p, atol=F32_TOL, rtol=0)


def test_plain_versions_match_pallas_bodies_bf16():
    b, s, h, hd = 2, 17, 4, 16
    qkv, g = _inputs(b, s, h, hd, seed=2)
    scale = 1.0 / np.sqrt(hd)
    qkv_j, g_j = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    out_p = np.asarray(_pallas_fwd(qkv_j, scale, h).astype(jnp.float32))
    dqkv_p = np.asarray(_pallas_bwd(qkv_j, g_j, scale, h).astype(jnp.float32))
    qkv_t = torch.from_numpy(np.array(qkv_j.astype(jnp.float32))).bfloat16()
    g_t = torch.from_numpy(np.array(g_j.astype(jnp.float32))).bfloat16()
    out_t = T.qkv_attention_plain(qkv_t, scale, h)
    dqkv_t = T.qkv_attention_bwd_plain(qkv_t, g_t, scale, h)
    assert out_t.dtype == dqkv_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(), out_p, atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(dqkv_t.float().numpy(), dqkv_p, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_plain_versions_match_pallas_bodies_bf16_long(shape):
    b, s, h, hd = shape
    qkv, g = _inputs(b, s, h, hd, seed=5)
    scale = 1.0 / np.sqrt(hd)
    qkv_j, g_j = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    out_p = np.asarray(_pallas_fwd(qkv_j, scale, h).astype(jnp.float32))
    dqkv_p = np.asarray(_pallas_bwd(qkv_j, g_j, scale, h).astype(jnp.float32))
    qkv_t = torch.from_numpy(np.array(qkv_j.astype(jnp.float32))).bfloat16()
    g_t = torch.from_numpy(np.array(g_j.astype(jnp.float32))).bfloat16()
    out_t = T.qkv_attention_plain(qkv_t, scale, h)
    dqkv_t = T.qkv_attention_bwd_plain(qkv_t, g_t, scale, h)
    np.testing.assert_allclose(out_t.float().numpy(), out_p, atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(dqkv_t.float().numpy(), dqkv_p, atol=BF16_TOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    qkv, g = _inputs(1, 5, 2, 16)
    T.reset_launches()
    x = torch.from_numpy(qkv).requires_grad_()
    T.fused_qkv_attention(x, 0.25, 2).backward(torch.from_numpy(g))
    assert {"qkv_fwd", "qkv_bwd"} <= set(T.LAUNCHES)
    assert T.LAUNCHES == dict.fromkeys(T.LAUNCHES, 0)
    ref = T.qkv_attention_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(g), 0.25, 2)
    assert torch.equal(x.grad, ref)


def test_other_devices_raise():
    qkv = torch.zeros(1, 4, 48, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        T.qkv_attention_forward(qkv, 0.25, 3)


def test_cuda_wrappers_refuse_cpu_tensors():
    qkv, g = _inputs(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.qkv_attention_cuda(torch.from_numpy(qkv), 0.25, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.qkv_attention_bwd_cuda(torch.from_numpy(qkv), torch.from_numpy(g), 0.25, 2)
