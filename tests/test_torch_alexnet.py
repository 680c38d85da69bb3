"""The port's AlexNets (``AlexNet_TRGP``, ``AlexNet_API``) against the JAX
package's, in float32 at their only geometry (32x32), from the same weights
(the JAX parameters converted by ``libcontinual_tpu_torch.convert``).

Held: the features in train mode with the JAX run's dropout masks fed in
(recorded from ``jax.random.bernoulli`` as flax's ``Dropout`` draws them,
moved to NCHW), the features in eval mode (batch statistics there too, so a
prediction depends on its batch), the captured layer inputs, the gradients
of every layer, ``weight_override``, API's expansion with some slots active,
``conv_patches``' row and column order against the JAX im2col and the
flattened-kernel helpers against the JAX kernel layout, and the AlexNet
transform preset."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.data import transforms as jtf  # noqa: E402
from libcontinual_tpu.models import alexnet as jalex  # noqa: E402
from libcontinual_tpu_torch import convert  # noqa: E402
from libcontinual_tpu_torch.data import transforms as ttf  # noqa: E402
from libcontinual_tpu_torch.models import alexnet as talex  # noqa: E402

#: float32 on the CPU through 3 convolutions, 2 fc layers and 5 batch
#: normalisations: the same arithmetic in another summation order
TOL = 1e-4
#: gradients, relative to the largest entry of the JAX one (the backward
#: through 5 batch normalisations sums over the batch's pixels)
GRAD_TOL = 1e-4


def assert_close_to_scale(got, want, tol=GRAD_TOL, err_msg=""):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=err_msg)


@contextlib.contextmanager
def recorded_bernoulli(masks: list):
    """Within it, every ``jax.random.bernoulli`` draw (flax's ``Dropout``,
    the ViT adapter's dropout) is appended to ``masks``."""
    orig = jax.random.bernoulli

    def record(*args, **kwargs):
        m = orig(*args, **kwargs)
        masks.append(m)
        return m

    jax.random.bernoulli = record
    try:
        yield
    finally:
        jax.random.bernoulli = orig


def nchw_keep(masks) -> list:
    """JAX dropout masks (NHWC, or (B, F)) as the port's keep masks (NCHW)."""
    out = []
    for m in masks:
        m = torch.from_numpy(np.array(m))
        out.append(m.permute(0, 3, 1, 2) if m.dim() == 4 else m)
    return out


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def pair(kind, seed=0, slots=2, k_slot=3):
    """(JAX module, JAX params, port module) with the same weights."""
    if kind == "trgp":
        jm, tm = jalex.AlexNetTRGP(), talex.AlexNetTRGP()
        args = ()
    else:
        jm = jalex.AlexNetAPI(slots=slots, k_slot=k_slot)
        tm = talex.AlexNetAPI(slots=slots, k_slot=k_slot)
        args = ([jnp.zeros((slots, k_slot))] * 5,)
    x = jnp.zeros((2, 32, 32, 3))
    params = jm.init(jax.random.PRNGKey(seed), x, *args, train=False)["params"]
    if kind == "api":  # non-zero mixes in the active slots
        rng = np.random.RandomState(seed)
        params = dict(params)
        for i in range(5):
            params[f"ws{i}"] = jnp.asarray(rng.randn(*params[f"ws{i}"].shape).astype(np.float32)
                                           * 0.3)
    convert.load_alexnet(tm, _numpy(params))
    return jm, params, tm


def ws_mask(slots=2, k_slot=3, counts=((1, 0), (2, 1), (0, 3), (3, 0), (1, 1))):
    return [(np.arange(k_slot)[None, :] < np.asarray(c)[:, None]).astype(np.float32)
            for c in counts]


def images(seed, b=6):
    return np.random.RandomState(seed).randn(b, 32, 32, 3).astype(np.float32)


def _apply_jax(jm, params, x, masks, train, key=None, **kw):
    rngs = {"dropout": key} if key is not None else None
    drawn = []
    with recorded_bernoulli(drawn):
        out = jm.apply({"params": params}, jnp.asarray(x), *masks, train=train, rngs=rngs, **kw)
    return out, drawn


@pytest.mark.parametrize("kind", ["trgp", "api"])
@pytest.mark.parametrize("train", [True, False])
def test_features_and_capture_match_jax(kind, train):
    """Train mode with the JAX dropout masks fed in, and eval mode; the
    captured inputs of the 5 layers (NCHW for the convs on the port)."""
    jm, params, tm = pair(kind)
    x = images(1)
    jmask = ws_mask() if kind == "api" else []
    key = jax.random.PRNGKey(7) if train else None
    out_j, drawn = _apply_jax(jm, params, x, ([[jnp.asarray(m) for m in jmask]] if jmask else []),
                              train, key,
                              capture=True)
    assert len(drawn) == (5 if train else 0)
    keep = nchw_keep(drawn) if train else None
    tmask = [torch.from_numpy(m) for m in jmask] if jmask else None
    out_t = tm(torch.from_numpy(x), ws_mask=tmask, capture=True, keep=keep)
    if train:  # the masks drop something in every layer
        assert all(0 < float(k.float().mean()) < 1 for k in keep)
    np.testing.assert_allclose(out_t["features"].detach().numpy(), np.asarray(out_j["features"]),
                               atol=TOL, rtol=TOL)
    for i, (got, want) in enumerate(zip(out_t["layer_inputs"], out_j["layer_inputs"])):
        got = got.detach()
        if got.dim() == 4:
            got = got.permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"layer input {i}")


@pytest.mark.parametrize("kind", ["trgp", "api"])
def test_layer_gradients_match_jax(kind):
    """The gradient of a fixed random projection of the train-mode features
    with respect to each layer's weight, in the flattened ``(in_flat, out)``
    rows both sides project (``kernel_rows``), and the batch norms' and the
    mixes' gradients."""
    jm, params, tm = pair(kind, seed=2)
    x = images(3)
    u = np.random.RandomState(4).randn(2048, 8).astype(np.float32)
    jmask = ws_mask() if kind == "api" else []
    key = jax.random.PRNGKey(5)

    def f(p):
        out = jm.apply({"params": p}, jnp.asarray(x),
                       *([[jnp.asarray(m) for m in jmask]] if jmask else []), train=True,
                       rngs={"dropout": key})
        return jnp.sum(out["features"] @ jnp.asarray(u))

    drawn = []
    with recorded_bernoulli(drawn):
        grads = jax.grad(f)(params)
    keep = nchw_keep(drawn)
    tmask = [torch.from_numpy(m) for m in jmask] if jmask else None
    feats = tm(torch.from_numpy(x), ws_mask=tmask, keep=keep)["features"]
    (feats @ torch.from_numpy(u)).sum().backward()
    for name, w in zip(talex.LAYER_NAMES, tm.layer_weights()):
        want = np.asarray(grads[f"{name}_kernel"])
        want = want.reshape(-1, want.shape[-1])  # the JAX kernel's (in_flat, out) rows
        got = talex.kernel_rows(w.grad).numpy()
        assert np.linalg.norm(want) > 100 * TOL
        assert_close_to_scale(got, want, err_msg=name)
    for i in range(5):
        bn = getattr(tm, f"bn{i}")
        assert_close_to_scale(bn.weight.grad.numpy(), grads[f"bn{i}"]["scale"])
        assert_close_to_scale(bn.bias.grad.numpy(), grads[f"bn{i}"]["bias"])
        if kind == "api":
            assert_close_to_scale(getattr(tm, f"ws{i}").grad.numpy(), grads[f"ws{i}"])


def test_weight_override_matches_jax():
    """Given weights (in each side's own layout) replace the parameters."""
    jm, params, tm = pair("trgp", seed=3)
    rng = np.random.RandomState(6)
    jax_wo = [np.asarray(params[f"{n}_kernel"]) * (1 + 0.5 * rng.rand(*params[f"{n}_kernel"].shape))
              .astype(np.float32) for n in talex.LAYER_NAMES]
    port_wo = [torch.from_numpy(w).permute(3, 2, 0, 1) if w.ndim == 4 else torch.from_numpy(w).T
               for w in jax_wo]
    x = images(4)
    out_j = jm.apply({"params": params}, jnp.asarray(x), train=False,
                     weight_override=[jnp.asarray(w) for w in jax_wo])
    out_t = tm(torch.from_numpy(x), weight_override=port_wo)
    plain = tm(torch.from_numpy(x))["features"]
    np.testing.assert_allclose(out_t["features"].detach().numpy(), np.asarray(out_j["features"]),
                               atol=TOL, rtol=TOL)
    assert float((plain - out_t["features"]).abs().max().detach()) > 1e-2


@pytest.mark.parametrize("kernel, c", [(4, 3), (3, 5), (2, 7)])
def test_conv_patches_and_kernel_rows_order(kernel, c):
    """``conv_patches`` (NCHW in) equals the JAX im2col (NHWC in) exactly,
    and a weight's ``kernel_rows`` are the JAX kernel's reshaped rows, so
    ``patches @ rows`` is the convolution on both sides."""
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 9, 8, c).astype(np.float32)
    want = np.asarray(jalex.conv_patches(jnp.asarray(x), kernel))
    got = talex.conv_patches(torch.from_numpy(x).permute(0, 3, 1, 2), kernel).numpy()
    np.testing.assert_array_equal(got, want)
    hwio = rng.randn(kernel, kernel, c, 4).astype(np.float32)
    oihw = torch.from_numpy(hwio).permute(3, 2, 0, 1)
    rows = talex.kernel_rows(oihw)
    np.testing.assert_array_equal(rows.numpy(), hwio.reshape(-1, 4))
    assert torch.equal(talex.rows_to_kernel(rows, oihw), oihw)
    conv = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), oihw)
    np.testing.assert_allclose((torch.from_numpy(got) @ rows).numpy(),
                               conv.permute(0, 2, 3, 1).reshape(-1, 4).numpy(), atol=1e-4)
    fc = torch.from_numpy(rng.randn(5, 11).astype(np.float32))
    assert torch.equal(talex.rows_to_kernel(talex.kernel_rows(fc), fc), fc)


def test_alexnet_transform_preset_matches_jax():
    """The ``alexnet`` preset: Normalize with ``alexnet_cifar``, train and
    test alike."""
    x = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    for mode in ("train", "test"):
        jp = jtf.build_transform(None, dataset="cifar100", backbone="alexnet", mode=mode)
        tp = ttf.build_transform(None, dataset="cifar100", backbone="alexnet", mode=mode)
        want = np.asarray(jp(jax.random.PRNGKey(0) if mode == "train" else None, jnp.asarray(x)))
        got = tp(torch.Generator().manual_seed(0) if mode == "train" else None,
                 torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert ttf.NORM_PRESETS["alexnet_cifar"] == tuple(jtf.NORM_PRESETS["alexnet_cifar"])
