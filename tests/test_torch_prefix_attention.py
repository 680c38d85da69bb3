"""The port's prefix-KV attention against the JAX package: the plain PyTorch
forward and backward (what a CPU tensor runs) against
``fused_prefix_attention`` with ``jax.vjp``, and against the Pallas kernel
bodies ``_pqkv_kernel`` / ``_pqkv_bwd_kernel`` run in interpret mode."""

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

from libcontinual_tpu_torch.ops import prefix_attention as T  # noqa: E402

A = importlib.import_module("libcontinual_tpu.ops.attention")

#: float32: the same arithmetic, summed in another order
F32_TOL = 1e-5
#: bfloat16: identical rounding points, so only a sum-order difference that
#: flips one bf16 rounding can show: two bf16 ulps at magnitude 2
BF16_TOL = 1.6e-2

# (B, S, P, H, hd): P 1, odd S, and P longer than S
SHAPES = [(2, 13, 3, 4, 16), (1, 17, 1, 2, 32), (2, 9, 10, 1, 64), (3, 5, 4, 2, 16)]
# P + S = 257 keys at hd 128, past the port's first kernels' 256; S 260 at
# hd 48 (no power of two)
LONG_SHAPES = [(1, 250, 7, 2, 128), (1, 260, 4, 1, 48)]
# the edges of the CUDA kernels' tiles at hd 64: S 16, 64, 65, 128, with
# P + S = 64, 65, 128 and 130 keys
EDGE_SHAPES = [(1, 16, 48, 1, 64), (1, 64, 1, 1, 64), (1, 65, 63, 1, 64), (1, 128, 2, 1, 64)]
SHAPES += LONG_SHAPES + EDGE_SHAPES


def _inputs(b, s, p, h, hd, seed=0):
    rng = np.random.RandomState(seed)
    d = h * hd
    return (rng.randn(b, s, 3 * d).astype(np.float32), rng.randn(b, p, d).astype(np.float32),
            rng.randn(b, p, d).astype(np.float32), rng.randn(b, s, d).astype(np.float32))


def _pallas_fwd(qkv, pk, pv, scale, heads):
    b, s, d3 = qkv.shape
    p = pk.shape[1]
    return pl.pallas_call(
        functools.partial(A._pqkv_kernel, scale=scale, heads=heads, bt=1),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, p, d3 // 3), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, p, d3 // 3), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, s, d3 // 3), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, s, d3 // 3), qkv.dtype),
        interpret=True,
    )(qkv, pk, pv)


def _pallas_bwd(qkv, pk, pv, g, scale, heads):
    b, s, d3 = qkv.shape
    d, p = d3 // 3, pk.shape[1]
    spec = lambda n, w: pl.BlockSpec((1, n, w), lambda i: (i, 0, 0))  # noqa: E731
    return pl.pallas_call(
        functools.partial(A._pqkv_bwd_kernel, scale=scale, heads=heads, bt=1),
        grid=(b,),
        in_specs=[spec(s, d3), spec(p, d), spec(p, d), spec(s, d)],
        out_specs=[spec(s, d3), spec(p, d), spec(p, d)],
        out_shape=[jax.ShapeDtypeStruct((b, s, d3), qkv.dtype),
                   jax.ShapeDtypeStruct((b, p, d), qkv.dtype),
                   jax.ShapeDtypeStruct((b, p, d), qkv.dtype)],
        interpret=True,
    )(qkv, pk, pv, g)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_vjp_match_jax(shape):
    b, s, p, h, hd = shape
    qkv, pk, pv, g = _inputs(*shape)
    scale = 1.0 / np.sqrt(hd)
    out_j, vjp = jax.vjp(lambda x, a, c: A.fused_prefix_attention(x, a, c, scale, h),
                         jnp.asarray(qkv), jnp.asarray(pk), jnp.asarray(pv))
    grads_j = vjp(jnp.asarray(g))

    ins = [torch.from_numpy(t).requires_grad_() for t in (qkv, pk, pv)]
    out_t = T.fused_prefix_attention(*ins, scale, h)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=F32_TOL, rtol=0)
    for name, t, j in zip(("dqkv", "dpk", "dpv"), ins, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=F32_TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_pallas_bodies_f32(shape):
    b, s, p, h, hd = shape
    qkv, pk, pv, g = _inputs(*shape, seed=1)
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(*map(jnp.asarray, (qkv, pk, pv)), scale, h))
    grads_p = _pallas_bwd(*map(jnp.asarray, (qkv, pk, pv, g)), scale, h)
    t = [torch.from_numpy(x) for x in (qkv, pk, pv, g)]
    out_t = T.prefix_attention_plain(*t[:3], scale, h)
    grads_t = T.prefix_attention_bwd_plain(*t, scale, h)
    np.testing.assert_allclose(out_t.numpy(), out_p, atol=F32_TOL, rtol=0)
    for name, a, j in zip(("dqkv", "dpk", "dpv"), grads_t, grads_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=F32_TOL, rtol=0, err_msg=name)


def test_plain_versions_match_pallas_bodies_bf16():
    b, s, p, h, hd = 2, 17, 3, 4, 16
    arrays = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(b, s, p, h, hd, seed=2)]
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(*arrays[:3], scale, h).astype(jnp.float32))
    grads_p = [np.asarray(x.astype(jnp.float32)) for x in _pallas_bwd(*arrays, scale, h)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16() for x in arrays]
    out_t = T.prefix_attention_plain(*t[:3], scale, h)
    grads_t = T.prefix_attention_bwd_plain(*t, scale, h)
    assert out_t.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads_t)
    np.testing.assert_allclose(out_t.float().numpy(), out_p, atol=BF16_TOL, rtol=0)
    for name, a, j in zip(("dqkv", "dpk", "dpv"), grads_t, grads_p):
        np.testing.assert_allclose(a.float().numpy(), j, atol=BF16_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_plain_versions_match_pallas_bodies_bf16_long(shape):
    b, s, p, h, hd = shape
    arrays = [jnp.asarray(x, jnp.bfloat16) for x in _inputs(b, s, p, h, hd, seed=5)]
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(*arrays[:3], scale, h).astype(jnp.float32))
    grads_p = [np.asarray(x.astype(jnp.float32)) for x in _pallas_bwd(*arrays, scale, h)]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16() for x in arrays]
    out_t = T.prefix_attention_plain(*t[:3], scale, h)
    grads_t = T.prefix_attention_bwd_plain(*t, scale, h)
    np.testing.assert_allclose(out_t.float().numpy(), out_p, atol=BF16_TOL, rtol=0)
    for name, a, j in zip(("dqkv", "dpk", "dpv"), grads_t, grads_p):
        np.testing.assert_allclose(a.float().numpy(), j, atol=BF16_TOL, rtol=0, err_msg=name)


def test_broadcast_prefix_gradient_sums_over_the_batch():
    """A prompt broadcast over the batch (stride 0, as DualPrompt trains)
    gets the sum of the per-image gradients."""
    b, s, p, h, hd = 3, 6, 2, 2, 16
    qkv, _, _, g = _inputs(b, s, p, h, hd, seed=3)
    rng = np.random.RandomState(4)
    base_k, base_v = (torch.from_numpy(rng.randn(p, h * hd).astype(np.float32)).requires_grad_()
                      for _ in range(2))
    out = T.fused_prefix_attention(torch.from_numpy(qkv), base_k[None].expand(b, -1, -1),
                                   base_v[None].expand(b, -1, -1), 0.25, h)
    out.backward(torch.from_numpy(g))
    _, dpk, dpv = T.prefix_attention_bwd_plain(
        torch.from_numpy(qkv), base_k.detach()[None].repeat(b, 1, 1),
        base_v.detach()[None].repeat(b, 1, 1), torch.from_numpy(g), 0.25, h)
    torch.testing.assert_close(base_k.grad, dpk.sum(0), atol=F32_TOL, rtol=0)
    torch.testing.assert_close(base_v.grad, dpv.sum(0), atol=F32_TOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    qkv, pk, pv, g = _inputs(1, 5, 2, 2, 16)
    T.reset_launches()
    ins = [torch.from_numpy(t).requires_grad_() for t in (qkv, pk, pv)]
    T.fused_prefix_attention(*ins, 0.25, 2).backward(torch.from_numpy(g))
    assert T.LAUNCHES == {"pqkv_fwd": 0, "pqkv_bwd": 0}
    ref = T.prefix_attention_bwd_plain(*(torch.from_numpy(t) for t in (qkv, pk, pv, g)), 0.25, 2)
    for t, r in zip(ins, ref):
        assert torch.equal(t.grad, r)


def test_other_devices_raise():
    qkv = torch.zeros(1, 4, 48, device="meta")
    pk = torch.zeros(1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        T.prefix_attention_forward(qkv, pk, pk, 0.25, 2)
    with pytest.raises(ValueError, match="no implementation"):
        T.prefix_attention_backward(qkv, pk, pk, torch.zeros(1, 4, 16, device="meta"), 0.25, 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    qkv, pk, pv, g = (torch.from_numpy(t) for t in _inputs(1, 4, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.prefix_attention_cuda(qkv, pk, pv, 0.25, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.prefix_attention_bwd_cuda(qkv, pk, pv, g, 0.25, 2)
