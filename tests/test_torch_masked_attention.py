"""The port's additive-mask attention against the JAX package: the plain
PyTorch forward and backward (what a CPU tensor runs) against the Pallas
kernel bodies ``_mqkv_kernel`` / ``_mqkv_bwd_kernel`` run in interpret mode,
in f32 and bf16, with the causal mask and with a random finite mask; and the
autograd function against ``jax.vjp`` of ``fused_masked_qkv_attention``."""

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

from libcontinual_tpu_torch.ops import masked_attention as T  # noqa: E402

A = importlib.import_module("libcontinual_tpu.ops.attention")

#: float32: the same arithmetic, summed in another order
F32_TOL = 1e-5
#: bfloat16: identical rounding points, so only a sum-order difference that
#: flips one bf16 rounding can show: two bf16 ulps at magnitude 2
BF16_TOL = 1.6e-2

# (B, S, H, hd): odd S, and the text tower's 77 at the tiny model's hd 16
SHAPES = [(2, 13, 4, 16), (1, 17, 2, 32), (2, 9, 1, 64), (2, 77, 4, 16)]
# past 256 keys and the 16/32/64 head dims: S 300 at hd 128, S 260 at hd 48
LONG_SHAPES = [(1, 300, 2, 128), (1, 260, 1, 48)]
# the edges of the CUDA kernels' tiles at hd 64: a warp's 16 rows and a
# block's 64 (S 16, 64, 65, 128)
EDGE_SHAPES = [(1, 16, 1, 64), (1, 64, 1, 64), (1, 65, 1, 64), (1, 128, 1, 64)]
SHAPES += LONG_SHAPES + EDGE_SHAPES
MASKS = ["causal", "random"]


def _mask(s, kind, rng):
    if kind == "causal":
        return np.triu(np.full((s, s), -1e30, np.float32), k=1)
    # a general finite additive mask: the kernel is held to the function,
    # not to a causal special case
    return (rng.randn(s, s) * 3.0).astype(np.float32)


def _inputs(b, s, h, hd, kind, seed=0):
    rng = np.random.RandomState(seed)
    d = h * hd
    qkv = rng.randn(b, s, 3 * d).astype(np.float32)
    g = rng.randn(b, s, d).astype(np.float32)
    return qkv, _mask(s, kind, rng), g


def _pallas_fwd(qkv, mask, scale, heads):
    b, s, d3 = qkv.shape
    return pl.pallas_call(
        functools.partial(A._mqkv_kernel, scale=scale, heads=heads, bt=1),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0)),
                  pl.BlockSpec((s, s), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, s, d3 // 3), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, s, d3 // 3), qkv.dtype),
        interpret=True,
    )(qkv, mask)


def _pallas_bwd(qkv, mask, g, scale, heads):
    b, s, d3 = qkv.shape
    return pl.pallas_call(
        functools.partial(A._mqkv_bwd_kernel, scale=scale, heads=heads, bt=1),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0)),
                  pl.BlockSpec((s, s), lambda i: (0, 0)),
                  pl.BlockSpec((1, s, d3 // 3), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, s, d3), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, s, d3), qkv.dtype),
        interpret=True,
    )(qkv, mask, g)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_vjp_match_jax(shape, kind):
    b, s, h, hd = shape
    qkv, mask, g = _inputs(*shape, kind)
    scale = 1.0 / np.sqrt(hd)
    out_j, vjp = jax.vjp(lambda x: A.fused_masked_qkv_attention(x, jnp.asarray(mask), scale, h),
                         jnp.asarray(qkv))
    (grad_j,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(qkv).requires_grad_()
    m = torch.from_numpy(mask)
    out_t = T.fused_masked_qkv_attention(x, m, scale, h)
    out_t.backward(torch.from_numpy(g))
    assert m.grad is None
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_pallas_bodies_f32(shape, kind):
    b, s, h, hd = shape
    qkv, mask, g = _inputs(*shape, kind, seed=1)
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(jnp.asarray(qkv), jnp.asarray(mask), scale, h))
    grad_p = np.asarray(_pallas_bwd(jnp.asarray(qkv), jnp.asarray(mask), jnp.asarray(g), scale, h))
    t = [torch.from_numpy(a) for a in (qkv, mask, g)]
    np.testing.assert_allclose(T.masked_attention_plain(t[0], t[1], scale, h).numpy(), out_p,
                               atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(T.masked_attention_bwd_plain(*t, scale, h).numpy(), grad_p,
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("kind", MASKS)
def test_plain_versions_match_pallas_bodies_bf16(kind):
    b, s, h, hd = 2, 17, 4, 16
    qkv, mask, g = _inputs(b, s, h, hd, kind, seed=2)
    qkv_j, g_j = (jnp.asarray(a, jnp.bfloat16) for a in (qkv, g))
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(qkv_j, jnp.asarray(mask), scale, h).astype(jnp.float32))
    grad_p = np.asarray(_pallas_bwd(qkv_j, jnp.asarray(mask), g_j, scale, h).astype(jnp.float32))
    qkv_t, g_t = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (qkv_j, g_j))
    m = torch.from_numpy(mask)
    out_t = T.masked_attention_plain(qkv_t, m, scale, h)
    grad_t = T.masked_attention_bwd_plain(qkv_t, m, g_t, scale, h)
    assert out_t.dtype == grad_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(), out_p, atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(grad_t.float().numpy(), grad_p, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_plain_versions_match_pallas_bodies_bf16_long(shape, kind):
    b, s, h, hd = shape
    qkv, mask, g = _inputs(b, s, h, hd, kind, seed=5)
    qkv_j, g_j = (jnp.asarray(a, jnp.bfloat16) for a in (qkv, g))
    scale = 1.0 / np.sqrt(hd)
    out_p = np.asarray(_pallas_fwd(qkv_j, jnp.asarray(mask), scale, h).astype(jnp.float32))
    grad_p = np.asarray(_pallas_bwd(qkv_j, jnp.asarray(mask), g_j, scale, h).astype(jnp.float32))
    qkv_t, g_t = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (qkv_j, g_j))
    m = torch.from_numpy(mask)
    out_t = T.masked_attention_plain(qkv_t, m, scale, h)
    grad_t = T.masked_attention_bwd_plain(qkv_t, m, g_t, scale, h)
    np.testing.assert_allclose(out_t.float().numpy(), out_p, atol=BF16_TOL, rtol=0)
    np.testing.assert_allclose(grad_t.float().numpy(), grad_p, atol=BF16_TOL, rtol=0)


def test_causal_mask_hides_the_future_exactly():
    """A -1e30 entry gives a probability of exactly 0: row 0 attends only to
    itself, so its output is its own value row, and the gradient reaches no
    key or value of a later position from an earlier query."""
    qkv, mask, _ = _inputs(1, 6, 2, 16, "causal", seed=3)
    x = torch.from_numpy(qkv).requires_grad_()
    out = T.fused_masked_qkv_attention(x, torch.from_numpy(mask), 0.25, 2)
    torch.testing.assert_close(out[0, 0], x[0, 0, 64:].detach(), atol=0, rtol=0)
    out[0, 2].sum().backward()
    assert torch.count_nonzero(x.grad[0, 3:]) == 0


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    qkv, mask, g = _inputs(1, 5, 2, 16, "causal")
    T.reset_launches()
    x = torch.from_numpy(qkv).requires_grad_()
    T.fused_masked_qkv_attention(x, torch.from_numpy(mask), 0.25, 2).backward(torch.from_numpy(g))
    assert T.LAUNCHES == {"mqkv_fwd": 0, "mqkv_bwd": 0}
    ref = T.masked_attention_bwd_plain(*(torch.from_numpy(a) for a in (qkv, mask, g)), 0.25, 2)
    assert torch.equal(x.grad, ref)


def test_other_devices_raise():
    qkv = torch.zeros(1, 4, 48, device="meta")
    mask = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        T.masked_attention_forward(qkv, mask, 0.25, 2)
    with pytest.raises(ValueError, match="no implementation"):
        T.masked_attention_backward(qkv, mask, torch.zeros(1, 4, 16, device="meta"), 0.25, 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    qkv, mask, g = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, "causal"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.masked_attention_cuda(qkv, mask, 0.25, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T.masked_attention_bwd_cuda(qkv, mask, g, 0.25, 2)
