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
from libcontinual_tpu_torch.ops import masked_attention as MT  # noqa: E402
from libcontinual_tpu_torch.ops import prefix_attention as PT  # noqa: E402

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


#: the packed-qkv op's modes: its kernel kinds' stem in ``LAUNCHES``, the
#: module of the mode's functions and their stem
MODES = {"qkv": ("qkv", T, "qkv_attention"), "prefix": ("pqkv", PT, "prefix_attention"),
         "masked": ("mqkv", MT, "masked_attention")}


def _mode_inputs(mode, b, s, h, hd, dtype=torch.float32, device="cpu", p=3, seed=0):
    """qkv, the mode's extra inputs (the prefix's pk and pv, or a causal
    mask) and an output gradient g."""
    rng = np.random.RandomState(seed)
    d = h * hd

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)

    qkv, g = rand(b, s, 3 * d), rand(b, s, d)
    if mode == "prefix":
        extra = [rand(b, p, d), rand(b, p, d)]
    elif mode == "masked":
        extra = [torch.triu(torch.full((s, s), -1e30), diagonal=1).to(device)]
    else:
        extra = []
    return qkv, extra, g


def _fns(mode):
    """The mode's fused entry and its four functions: (entry, kernel forward,
    kernel backward, plain forward, plain backward)."""
    _, mod, stem = MODES[mode]
    entry = {"qkv": T.fused_qkv_attention, "prefix": PT.fused_prefix_attention,
             "masked": MT.fused_masked_qkv_attention}[mode]
    return (entry, *(getattr(mod, stem + tail) for tail in ("_cuda", "_bwd_cuda", "_plain",
                                                             "_bwd_plain")))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("mode", list(MODES))
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(mode):
    """Through the mode's fused entry, a CPU tensor runs the plain forward
    and backward (every gradient equal to the plain backward's: qkv's, and
    the prefix's pk and pv), and no kernel is counted."""
    entry, _, _, _, bwd_plain = _fns(mode)
    qkv, extra, g = _mode_inputs(mode, 1, 5, 2, 16)
    T.reset_launches()
    leaves = [qkv] + (extra if mode == "prefix" else [])  # a mask gets no gradient
    for t in leaves:
        t.requires_grad_()
    entry(qkv, *extra, 0.25, 2).backward(g)
    kind = MODES[mode][0]
    assert {kind + "_fwd", kind + "_bwd"} <= set(T.LAUNCHES)
    assert T.LAUNCHES == dict.fromkeys(T.LAUNCHES, 0)
    ref = _as_tuple(bwd_plain(*(t.detach() for t in (qkv, *extra)), g, 0.25, 2))
    assert len(ref) == len(leaves)
    for t, r in zip(leaves, ref):
        assert torch.equal(t.grad, r)


@pytest.mark.parametrize("family", ["qkv", "prefix", "masked"])
def test_cpu_tensors_count_no_onepass_launch(family):
    """A bf16 forward at a shape the one-pass kernel takes on the card (hd 64,
    20 keys) runs the plain version on a CPU tensor: the ``*_fwd_onepass``
    counter is there and stays 0, like every other."""
    qkv, extra, _ = _mode_inputs(family, 1, 20, 1, 64, torch.bfloat16)
    T.reset_launches()
    out = T._routed(family, False, qkv, *extra, 0.125, 1)
    assert out.shape == (1, 20, 64) and out.dtype == torch.bfloat16
    assert MODES[family][0] + "_fwd_onepass" in T.LAUNCHES
    assert T.LAUNCHES == dict.fromkeys(T.LAUNCHES, 0)


@pytest.mark.parametrize("family", ["qkv", "prefix", "masked"])
def test_cpu_backward_counts_no_onepass_launch(family):
    """A bf16 backward at a shape the one-pass backward takes on the card (hd
    64, 20 keys) runs the plain version on a CPU tensor: the
    ``*_bwd_onepass`` counter is there and stays 0, like every other."""
    qkv, extra, go = _mode_inputs(family, 1, 20, 1, 64, torch.bfloat16)
    T.reset_launches()
    grads = _as_tuple(T._routed(family, True, qkv, *extra, go, 0.125, 1))
    assert grads[0].shape == (1, 20, 192) and all(d.dtype == torch.bfloat16 for d in grads)
    assert MODES[family][0] + "_bwd_onepass" in T.LAUNCHES
    assert T.LAUNCHES == dict.fromkeys(T.LAUNCHES, 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_other_devices_raise(mode):
    qkv, extra, g = _mode_inputs(mode, 1, 4, 2, 16, device="meta")
    entry = _fns(mode)[0]
    with pytest.raises(ValueError, match="no implementation"):
        entry(qkv, *extra, 0.25, 2)
    with pytest.raises(ValueError, match="no implementation"):
        T._routed(mode, True, qkv, *extra, g, 0.25, 2)


@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_wrappers_refuse_cpu_tensors(mode):
    _, fwd_cuda, bwd_cuda, _, _ = _fns(mode)
    qkv, extra, g = _mode_inputs(mode, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fwd_cuda(qkv, *extra, 0.25, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bwd_cuda(qkv, *extra, g, 0.25, 2)


@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_route_calls_each_kernel_wrapper_through_its_module(mode, monkeypatch):
    """The contract the benchmark's per-layer metric rests on
    (``bench_port/trace.py:record_launches`` replaces the six ``*_cuda``
    names on their modules and reads their positional arguments): on the
    CUDA route, the one autograd node calls the mode's two kernel wrappers
    through their module, once per direction, with qkv first, the prefix's
    pk second and heads last; the results are the wrappers' own. Here each
    wrapper is replaced by a recorder that runs the mode's plain version."""
    entry, _, _, fwd_plain, bwd_plain = _fns(mode)
    kind, mod, stem = MODES[mode]
    calls = []

    def recorder(kname, plain):
        def call(*args):  # positional only, as record_launches' wrappers take them
            qkv, heads = args[0], args[-1]
            p = (args[1].shape[1],) if kname.startswith("pqkv") else ()
            calls.append((kname, (qkv.shape[0], qkv.shape[1], *p, qkv.shape[2] // 3, int(heads))))
            return plain(*args)
        return call

    monkeypatch.setattr(mod, stem + "_cuda", recorder(kind + "_fwd", fwd_plain))
    monkeypatch.setattr(mod, stem + "_bwd_cuda", recorder(kind + "_bwd", bwd_plain))
    monkeypatch.setattr(T, "_route", lambda t, name: "cuda")
    qkv, extra, g = _mode_inputs(mode, 2, 5, 2, 16)
    leaves = [qkv] + (extra if mode == "prefix" else [])
    for t in leaves:
        t.requires_grad_()
    out = entry(qkv, *extra, 0.25, 2)
    out.backward(g)
    shape = (2, 5, 3, 32, 2) if mode == "prefix" else (2, 5, 32, 2)
    assert calls == [(kind + "_fwd", shape), (kind + "_bwd", shape)]
    ins = [t.detach() for t in (qkv, *extra)]
    assert torch.equal(out, fwd_plain(*ins, 0.25, 2))
    for t, r in zip(leaves, _as_tuple(bwd_plain(*ins, g, 0.25, 2))):
        assert torch.equal(t.grad, r)
