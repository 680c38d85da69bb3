"""The port's ViT against the JAX package's: ``vit_tiny_test`` in float32
with the JAX parameters converted by ``libcontinual_tpu_torch.convert``,
with and without prepended prompt tokens; and the initial distributions."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.models import vit as jvit  # noqa: E402
from libcontinual_tpu_torch import convert  # noqa: E402
from libcontinual_tpu_torch.models import vit as tvit  # noqa: E402
from libcontinual_tpu_torch.models.heads import LinearHead  # noqa: E402

#: float32 on the CPU: the same arithmetic in another summation order,
#: through 4 blocks
TOL = 1e-4


def _pair(block_ln_eps):
    jm = jvit.vit_tiny_test(dtype=jnp.float32, block_ln_eps=block_ln_eps)
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)["params"]
    tm = tvit.vit_tiny_test(dtype=torch.float32, block_ln_eps=block_ln_eps)
    convert.load_vit(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm, x


@pytest.mark.parametrize("block_ln_eps", [1e-6, 1e-5])
def test_vit_tiny_matches_jax(block_ln_eps):
    jm, params, tm, x = _pair(block_ln_eps)
    out_j = jm.apply({"params": params}, jnp.asarray(x), train=False)
    out_t = tm(torch.from_numpy(x))
    for key in ("features", "tokens"):
        assert out_t[key].dtype == torch.float32
        np.testing.assert_allclose(out_t[key].detach().numpy(), np.asarray(out_j[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)


def test_vit_tiny_prompted_matches_jax():
    jm, params, tm, x = _pair(1e-5)
    prompts = np.random.RandomState(2).rand(3, 6, 64).astype(np.float32)
    out_j = jm.apply({"params": params}, jnp.asarray(x), train=False,
                     prepend_tokens=jnp.asarray(prompts), feature_mode="prompt_mean")
    out_t = tm(torch.from_numpy(x), prepend_tokens=torch.from_numpy(prompts),
               feature_mode="prompt_mean")
    assert out_t["tokens"].shape == (3, 6 + 17, 64)
    for key in ("features", "tokens"):
        np.testing.assert_allclose(out_t[key].detach().numpy(), np.asarray(out_j[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)


@pytest.mark.parametrize("per_image", [False, True])
def test_vit_tiny_prefix_kv_matches_jax(per_image):
    """Prefix keys and values on blocks 0 and 2, broadcast over the batch (as
    DualPrompt trains) or one per image (as it evaluates); features and the
    prefix gradients of a fixed random projection of the features (the CLS
    readout leaves the final LayerNorm with a norm that does not depend on
    the input, so the gradient of sum(features ** 2) would be noise)."""
    jm, params, tm, x = _pair(1e-5)
    rng = np.random.RandomState(3)
    lens = {0: 3, 2: 5}
    kv = {i: [rng.rand(3 if per_image else 1, n, 64).astype(np.float32) for _ in range(2)]
          for i, n in lens.items()}
    u = rng.randn(64, 8).astype(np.float32)
    jkv = {i: tuple(jnp.broadcast_to(jnp.asarray(a), (3,) + a.shape[1:]) for a in pair)
           for i, pair in kv.items()}

    def jfeat(jkv):
        out = jm.apply({"params": params}, jnp.asarray(x), train=False, prefix_kv=jkv)
        return jnp.sum(out["features"] @ jnp.asarray(u)), out["features"]

    (_, feat_j), grads_j = jax.value_and_grad(jfeat, has_aux=True)(jkv)
    leaves = {i: [torch.from_numpy(a).requires_grad_() for a in pair] for i, pair in kv.items()}
    tkv = {i: tuple(t.expand(3, -1, -1) for t in pair) for i, pair in leaves.items()}
    feat_t = tm(torch.from_numpy(x), prefix_kv=tkv)["features"]
    (feat_t @ torch.from_numpy(u)).sum().backward()
    np.testing.assert_allclose(feat_t.detach().numpy(), np.asarray(feat_j), atol=TOL, rtol=TOL)
    for i, pair in leaves.items():
        for t, j in zip(pair, grads_j[i]):
            j = np.asarray(j) if per_image else np.asarray(j).sum(0, keepdims=True)
            # a gradient that the tolerance could not tell from zero tests nothing
            assert np.linalg.norm(j) > 100 * TOL
            np.testing.assert_allclose(t.grad.numpy(), j, atol=TOL, rtol=TOL)


def test_bf16_forward_keeps_the_rounding_points():
    _, _, tm, x = _pair(1e-5)
    tm = tm.to(torch.bfloat16)
    for m in tm.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.bfloat16
    out = tm(torch.from_numpy(x), prepend_tokens=torch.rand(3, 4, 64), feature_mode="prompt_mean")
    # final norm and features in f32, residual stream in bf16 until then
    assert out["features"].dtype == out["tokens"].dtype == torch.float32
    assert torch.isfinite(out["tokens"]).all()


def _std(a):
    return float(np.std(np.asarray(a, np.float64)))


def test_initial_distributions_match_jax():
    jm = jvit.VisionTransformer(img_size=32, patch_size=8, embed_dim=256, depth=1,
                                num_heads=4, dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"]
    tm = tvit.VisionTransformer(img_size=32, patch_size=8, embed_dim=256, depth=1,
                                num_heads=4, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(0))
    pairs = [
        (p["patch_embed"]["kernel"], tm.patch_embed.weight),
        (p["block_0"]["attn"]["qkv"]["kernel"], tm.blocks[0].attn.qkv.weight),
        (p["block_0"]["mlp"]["fc2"]["kernel"], tm.blocks[0].mlp.fc2.weight),
        (p["pos_embed"], tm.pos_embed),
    ]
    for a, b in pairs:
        assert abs(_std(a) - _std(b.detach())) < 0.05 * _std(a)
    assert float(tm.pos_embed.detach().abs().max()) <= 0.04
    assert float(tm.blocks[0].attn.qkv.bias.detach().abs().max()) == 0.0
    head = LinearHead(256, 10, generator=torch.Generator().manual_seed(0))
    assert float(head.dense.weight.detach().abs().max()) <= np.sqrt(6.0 / 256)
    assert abs(_std(head.dense.weight.detach()) - np.sqrt(2.0 / 256)) < 0.1 * np.sqrt(2.0 / 256)
