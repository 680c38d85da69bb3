"""The port's generic attention op against the JAX package: ``attention_plain``
against ``_attention_kernel`` run in interpret mode (with ``_pallas_attention``'s
padding and ``kv_len`` mask), ``fused_attention`` and ``attention`` with their
gradients against the JAX op through ``jax.vjp``, and each Pallas variant's
plain version against its body in ``tools/bench_attention.py`` or
``tools/exp_flash_kernel.py`` (loaded by path, unchanged), in interpret mode;
then the port's two measurement tools on the CPU."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

torch.set_num_threads(1)

from libcontinual_tpu_torch.ops import attention as T  # noqa: E402

A = importlib.import_module("libcontinual_tpu.ops.attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BA = _load_tool("bench_attention")
EF = _load_tool("exp_flash_kernel")

#: float32: the same arithmetic, summed in another order
F32_TOL = 1e-5
#: float32 gradients (tests/test_ops.py's tolerance for the same VJP)
GRAD_TOL = 1e-4
#: bfloat16 against a body with the same rounding points: only a sum-order
#: difference that flips one bf16 rounding can show, two bf16 ulps at
#: magnitude 2 (outputs here stay below 2.5)
BF16_TOL = 1.6e-2
#: the port (P in f32) against ``_xla_attention`` (P rounded to bf16) at bf16:
#: a relative rounding of up to 2^-9 on every p moves an output by at most
#: 2^-9 * max |v| (about 8e-3 here), on top of BF16_TOL
XLA_BF16_TOL = BF16_TOL + 1e-2
#: the fast bodies in interpret mode: ``pl.reciprocal(approx=True)`` is an
#: approximation there (up to 1.3e-3 relative, measured), the plain version's
#: reciprocal is exact; that moves an output by up to 1.3e-3 * max |v|
#: (about 5e-3 here), on top of BF16_TOL
FAST_TOL = BF16_TOL + 6e-3

# (B, H, Sq, Skv, hd): Sq != Skv, Skv < Sq, Sq not a multiple of 8, hd 4, 8, 64
SHAPES = [(2, 3, 9, 13, 8), (1, 2, 17, 5, 4), (2, 2, 10, 19, 64), (1, 1, 3, 1, 8)]
# the edges of the card kernel's tiles (a warp's 16 query rows, a block's 64
# queries, the 64-key tiles) at hd 64, Sq == Skv and not, and one at hd 128;
# B * H even for the tool bodies' two heads a program
EDGE_SHAPES = [(1, 2, 16, 16, 64), (1, 2, 64, 65, 64), (1, 2, 128, 65, 64),
               (1, 2, 65, 128, 128)]


def _qkv(b, h, sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32), rng.randn(b, h, skv, d).astype(np.float32),
            rng.randn(b, h, skv, d).astype(np.float32))


def _as(x, dtype):
    """numpy f32 -> (jax array, torch tensor) holding the same values in
    ``dtype`` ("f32" or "bf16")."""
    j = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, (t.bfloat16() if dtype == "bf16" else t)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pallas_attention(q, k, v, scale):
    """``_pallas_attention`` in interpret mode: sequences padded to 8, the
    padded keys masked by ``kv_len``."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    qf, _ = A._pad_to(q.reshape(b * h, sq, d), 1, 8)
    kf, _ = A._pad_to(k.reshape(b * h, skv, d), 1, 8)
    vf, _ = A._pad_to(v.reshape(b * h, skv, d), 1, 8)
    sq_p, skv_p = qf.shape[1], kf.shape[1]
    out = pl.pallas_call(
        functools.partial(A._attention_kernel, scale=scale, kv_len=skv),
        grid=(b * h,),
        in_specs=[pl.BlockSpec((1, sq_p, d), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, skv_p, d), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, skv_p, d), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, sq_p, d), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b * h, sq_p, d), q.dtype),
        interpret=True,
    )(qf, kf, vf)
    return out[:, :sq, :].reshape(b, h, sq, d)


def _pallas_body(body, q, k, v, g, smult=16):
    """One tool body over ``g`` heads a program, sequences padded to
    ``smult`` as the tool pads them (``smult`` None: unpadded, as
    ``exp_flash_kernel`` runs; ``g`` None: 2-D refs, as ``pallas_2d``)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    pad = (lambda x: x) if smult is None else (lambda x: A._pad_to(x, 1, smult)[0])
    qf, kf, vf = (pad(x.reshape(b * h, x.shape[2], d)) for x in (q, k, v))
    sq_p, skv_p = qf.shape[1], kf.shape[1]
    blk = None if g is None else g
    out = pl.pallas_call(
        body,
        grid=(b * h // (g or 1),),
        in_specs=[pl.BlockSpec((blk, sq_p, d), lambda i: (i, 0, 0)),
                  pl.BlockSpec((blk, skv_p, d), lambda i: (i, 0, 0)),
                  pl.BlockSpec((blk, skv_p, d), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((blk, sq_p, d), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b * h, sq_p, d), q.dtype),
        interpret=True,
    )(qf, kf, vf)
    return out[:, :sq, :].reshape(b, h, sq, d)


# ------------------------------------------------- _attention_kernel (row 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
def test_plain_matches_attention_kernel_body(shape, dtype):
    *_, d = shape
    scale = 1.0 / np.sqrt(d)
    (qj, qt), (kj, kt), (vj, vt) = (_as(x, dtype) for x in _qkv(*shape, seed=1))
    want = _np(_pallas_attention(qj, kj, vj, scale))
    got = T.attention_plain(qt, kt, vt, scale)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# ------------------------------------------------ the op and its gradients

# tests/test_ops.py's shapes and scales, then Skv < Sq and a long Skv at hd 64
OP_CASES = [((2, 3, 9, 13, 8), None), ((1, 2, 5, 7, 4), 0.5), ((1, 2, 17, 5, 16), None),
            ((2, 1, 33, 70, 64), 0.1)]


def _port_vjp(fn, q, k, v, g, scale):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, scale)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("entry", ["fused_attention", "attention"])
@pytest.mark.parametrize("case", OP_CASES)
def test_op_and_gradients_match_jax_f32(case, entry):
    """``fused_attention`` against the JAX ``fused_attention`` (remat VJP);
    ``attention`` against the JAX ``attention()``, which on the CPU autodiffs
    ``_xla_attention``: at f32 both are the same function."""
    shape, scale = case
    q, k, v = _qkv(*shape, seed=2)
    g = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    jfn = getattr(A, entry)
    out_j, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, scale), *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    out_t, grads_t = _port_vjp(getattr(T, entry), q, k, v, g, scale)
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=F32_TOL, rtol=0)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt, np.asarray(gj), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 3, 9, 13, 8), (2, 2, 10, 19, 64)])
def test_attention_bf16_against_xla_attention(shape):
    """At bf16 the JAX op's CPU branch rounds P before ``P . v`` and the port
    does not: agreement within that rounding (XLA_BF16_TOL)."""
    *_, d = shape
    scale = 1.0 / np.sqrt(d)
    (qj, qt), (kj, kt), (vj, vt) = (_as(x, "bf16") for x in _qkv(*shape, seed=4))
    want = _np(A._xla_attention(qj, kj, vj, scale))
    got = T.attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=XLA_BF16_TOL, rtol=0)
    # the port's own copy of _xla_attention keeps its rounding point
    np.testing.assert_allclose(T.xla_attention_plain(qt, kt, vt, scale).float().numpy(), want,
                               atol=BF16_TOL, rtol=0)


def test_bf16_gradients_round_once_as_in_jax():
    shape = (1, 2, 9, 13, 8)
    (qj, qt), (kj, kt), (vj, vt) = (_as(x, "bf16") for x in _qkv(*shape, seed=5))
    gj, gt = _as(np.random.RandomState(6).randn(1, 2, 9, 8).astype(np.float32), "bf16")
    _, vjp = jax.vjp(lambda a, b, c: A.fused_attention(a, b, c, None), qj, kj, vj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    T.fused_attention(*leaves).backward(gt)
    for lt, want in zip(leaves, vjp(gj)):
        assert lt.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(lt.grad.float().numpy(), _np(want), atol=BF16_TOL, rtol=0)


def test_scale_none_is_one_over_sqrt_d():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 3, 9, 13, 8, seed=7))
    assert torch.equal(T.fused_attention(q, k, v), T.fused_attention(q, k, v, 1.0 / np.sqrt(8)))
    assert torch.equal(T.attention(q, k, v, None), T.attention_plain(q, k, v, 8 ** -0.5))
    want = A.fused_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), None)
    np.testing.assert_allclose(T.attention(q, k, v).numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 2, 5, 7, 4, seed=8))
    T.reset_launches()
    T.fused_attention(q, k, v).sum().backward()
    T.attention_variant(q.detach(), k.detach(), v.detach(), 0.5, "v2")
    assert set(T.LAUNCHES.values()) == {0}
    assert {"attn_fwd", "attn_fwd_v2", "attn_fwd_fast", "attn_fwd_mmonly", "attn_fwd_qblock",
            "attn_fwd_flash"} <= set(T.LAUNCHES)


def test_other_devices_raise():
    q = torch.empty(1, 2, 5, 4, device="meta")
    k = torch.empty(1, 2, 7, 4, device="meta")
    with pytest.raises(ValueError, match="no implementation for device meta"):
        T.fused_attention(q, k, k)
    with pytest.raises(ValueError, match="no implementation for device meta"):
        T.attention_variant(q, k, k, 0.5, "fast")


def test_variant_names_and_flash_lengths_are_checked():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 5, 7, 4))
    with pytest.raises(ValueError, match="unknown attention variant"):
        T.attention_variant(q, k, v, 0.5, "g8")
    with pytest.raises(ValueError, match="Sq == Skv"):
        T.attention_variant(q, k, v, 0.5, "flash")


def test_ops_attention_stays_a_module():
    """The port's ``ops/__init__.py`` re-exports nothing, so the module name
    ``attention`` is not shadowed by the function of the same name."""
    import libcontinual_tpu_torch.ops as ops

    mod = importlib.import_module("libcontinual_tpu_torch.ops.attention")
    assert isinstance(ops.attention, types.ModuleType) and ops.attention is mod is T
    assert callable(mod.attention) and callable(mod.fused_attention)


# ------------------------------------------ the Pallas variants (rows 10-11)

# (B, H, Sq, Skv, hd) with B * H even (two heads a program, as the tool's g)
V_SHAPES = [(2, 3, 9, 13, 8), (1, 2, 17, 5, 16), (2, 1, 20, 33, 64)]


def _bodies(scale, skv):
    """variant -> (Pallas body, heads a program, padding multiple)."""
    p = functools.partial
    return {
        "v2": (p(BA._kernel_v2, scale=scale, kv_len=skv, g=2, subtract_max=True), 2, 16),
        "v2_nomax": (p(BA._kernel_v2, scale=scale, kv_len=skv, g=2, subtract_max=False), 2, 16),
        "fast": (p(BA._kernel_fast, scale=scale, kv_len=skv, g=2, bf16_sm=False), 2, 16),
        "fast_bf16sm": (p(BA._kernel_fast, scale=scale, kv_len=skv, g=2, bf16_sm=True), 2, 16),
        "qblock": (p(BA._kernel_qblock, scale=scale, kv_len=skv), None, 16),
        "mmonly": (p(BA._kernel_mmonly, g=2), 2, 16),
    }


@pytest.mark.parametrize("variant", ["v2", "v2_nomax", "fast", "fast_bf16sm", "qblock", "mmonly"])
@pytest.mark.parametrize("shape", V_SHAPES + EDGE_SHAPES)
def test_variant_plain_matches_bench_attention_body(shape, variant):
    *_, skv, d = shape
    scale = 1.0 / np.sqrt(d)
    (qj, qt), (kj, kt), (vj, vt) = (_as(x, "bf16") for x in _qkv(*shape, seed=9))
    body, g, smult = _bodies(scale, skv)[variant]
    want = _np(_pallas_body(body, qj, kj, vj, g, smult))
    got = T.attention_variant_plain(qt, kt, vt, scale, variant)
    assert got.dtype == torch.bfloat16
    if variant == "mmonly":  # outputs of tens: two bf16 ulps of the largest
        tol = BF16_TOL * max(1.0, float(np.abs(want).max()) / 2)
    else:
        tol = FAST_TOL if variant in ("fast", "fast_bf16sm", "qblock") else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("shape", [(2, 3, 9, 9, 8), (1, 2, 17, 17, 64)])
def test_flash_plain_matches_exp_flash_kernel_body(shape):
    *_, d = shape
    scale = 1.0 / np.sqrt(d)
    (qj, qt), (kj, kt), (vj, vt) = (_as(x, "bf16") for x in _qkv(*shape, seed=10))
    body = functools.partial(EF.fwd_kernel, scale=scale, g=2)
    want = _np(_pallas_body(body, qj, kj, vj, 2, smult=None))
    got = T.attention_variant_plain(qt, kt, vt, scale, "flash")
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=0)
    # the same function as v2 on Sq == Skv
    assert torch.equal(got, T.attention_variant_plain(qt, kt, vt, scale, "v2"))


@pytest.mark.parametrize("kw", [{}, {"nomax": True}, {"nomax": True, "bf16_scores": True}])
def test_tool_xla_candidates_match_jax_tool(kw):
    from libcontinual_tpu_torch.tools import bench_attention as PB

    shape = (2, 3, 9, 13, 8)
    scale = 1.0 / np.sqrt(8)
    (qj, qt), (kj, kt), (vj, vt) = (_as(x, "bf16") for x in _qkv(*shape, seed=11))
    np.testing.assert_allclose(PB.xla_manual(qt, kt, vt, scale, **kw).float().numpy(),
                               _np(BA.xla_manual(qj, kj, vj, scale, **kw)), atol=BF16_TOL,
                               rtol=0)
    np.testing.assert_allclose(PB.xla_attn(qt, kt, vt, scale).float().numpy(),
                               _np(BA.xla_attn(qj, kj, vj, scale)), atol=BF16_TOL, rtol=0)


# ------------------------------------------------------- the tools on a CPU


def test_bench_attention_runs_the_plain_candidates_on_the_cpu(capsys):
    from libcontinual_tpu_torch.tools import bench_attention as PB

    res = PB.main(["--device", "cpu", "--b", "1", "--h", "2", "--sq", "9", "--skv", "13",
                   "--d", "8", "--iters", "2"])
    out = capsys.readouterr().out
    ran = {n for n, r in res.items() if "ms" in r}
    skipped = {n for n, r in res.items() if "skipped" in r}
    assert ran == {"xla", "xla_nomax", "xla_bf16scores"}
    assert skipped == {n for n in res if n.startswith(("pallas_", "sdpa_"))}
    assert {"sdpa_flash", "sdpa_cudnn", "pallas_g8", "pallas_attention"} <= skipped
    for name in skipped:
        assert f"{name:18s} skipped: CUDA only" in out
    assert res["xla"]["maxerr"] == 0.0 and res["xla_nomax"]["maxerr"] <= BF16_TOL
    assert "host clock" in out


def test_exp_flash_kernel_runs_on_the_cpu(capsys):
    from libcontinual_tpu_torch.tools import exp_flash_kernel as PE

    res = PE.main(["--device", "cpu", "--b", "1", "--iters", "1"])
    out = capsys.readouterr().out
    assert sorted(res) == [197, 222]
    assert all(r["err"] <= BF16_TOL and r["flash_ms"] > 0 for r in res.values())
    assert out.count("one configuration") == 2
