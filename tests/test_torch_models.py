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


# ------------------------------------------------- adapters and capture


def _adapter_pair(builder):
    """A 4-block ViT with 8-wide adapters and the same weights on both
    sides, the adapters' ``up`` drawn at random (it starts at zero, which
    would hide the adapter)."""
    if builder == "factory":  # both factories read adapter_dim and ignore act_layer
        kw = dict(adapter_dim=8, act_layer="QuickGELU", block_ln_eps=1e-5)
        jm = jvit.vit_tiny_test(dtype=jnp.float32, **kw)
        tm = tvit.vit_tiny_test(dtype=torch.float32, **kw)
    else:  # QuickGELU in the blocks' MLP
        kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4, adapter_dim=8,
                  act="quick_gelu", block_ln_eps=1e-5)
        jm = jvit.VisionTransformer(dtype=jnp.float32, **kw)
        tm = tvit.VisionTransformer(dtype=torch.float32, **kw)
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    params = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                                      train=False)["params"])
    rng = np.random.RandomState(5)
    for i in range(4):
        up = params[f"block_{i}"]["adaptmlp"]["up"]
        up["kernel"] = (rng.randn(*up["kernel"].shape) * 0.2).astype(np.float32)
        up["bias"] = (rng.randn(*up["bias"].shape) * 0.1).astype(np.float32)
    convert.load_vit(tm, params)
    return jm, params, tm, x


#: f32, the same arithmetic in another summation order (rtol, and atol for
#: entries near zero)
ADAPTER_TOL = 1e-5


@pytest.mark.parametrize("builder", ["factory", "quick_gelu"])
@pytest.mark.parametrize("capture_point", ["attn", "mlp"])
def test_adapter_vit_features_and_capture_match_jax(builder, capture_point):
    """Features and ``attn_inputs`` (each block's ``ln_1(x)``, or the raw
    post-attention residual the adapter reads), in evaluation and in
    training with the JAX adapter dropout masks fed in."""
    from test_torch_alexnet import recorded_bernoulli

    jm, params, tm, x = _adapter_pair(builder)
    assert tm.blocks[0].mlp.act == ("gelu" if builder == "factory" else "quick_gelu")
    for train in (False, True):
        drawn = []
        with recorded_bernoulli(drawn):
            out_j = jm.apply({"params": params}, jnp.asarray(x), train=train, capture=True,
                             capture_point=capture_point,
                             rngs={"dropout": jax.random.PRNGKey(3)} if train else None)
        keep = [torch.from_numpy(np.array(m)) for m in drawn] if train else None
        assert len(drawn) == (4 if train else 0)
        out_t = tm(torch.from_numpy(x), capture=True, capture_point=capture_point,
                   adapter_keep=keep)
        np.testing.assert_allclose(out_t["features"].detach().numpy(),
                                   np.asarray(out_j["features"]), rtol=ADAPTER_TOL,
                                   atol=ADAPTER_TOL)
        assert len(out_t["attn_inputs"]) == 4
        for i, (a, b) in enumerate(zip(out_t["attn_inputs"], out_j["attn_inputs"])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=ADAPTER_TOL,
                                       atol=ADAPTER_TOL, err_msg=f"{train} block {i}")


def test_vit_factories_read_the_jax_kwargs(monkeypatch):
    """``vitzoo`` and ``vit_tiny_test`` hand the model what the JAX factories
    hand theirs: adapters, QuickGELU (``act_layer``), the MoE experts
    (``experts_num``) and top-k, both LayerNorm eps."""
    monkeypatch.setattr(tvit, "VisionTransformer", lambda **kw: kw)
    fields = ("img_size", "adapter_dim", "moe_experts", "moe_top_k", "act", "block_ln_eps",
              "final_ln_eps")
    kw = dict(img_size=32, adapter_dim=64, act_layer="QuickGELU", experts_num=2, moe_top_k=1,
              block_ln_eps=1e-5, final_ln_eps=1e-5)
    jm, tm = jvit.vitzoo(**kw), tvit.vitzoo(**kw)
    assert {f: tm[f] for f in fields} == {f: getattr(jm, f) for f in fields}
    assert tm["act"] == "quick_gelu" and tm["moe_experts"] == 2
    kw = dict(adapter_dim=8, block_ln_eps=1e-5, final_ln_eps=1e-4)
    jm, tm = jvit.vit_tiny_test(**kw), tvit.vit_tiny_test(**kw)
    fields = ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "adapter_dim",
              "block_ln_eps", "final_ln_eps")
    assert {f: tm[f] for f in fields} == {f: getattr(jm, f) for f in fields}


@pytest.mark.parametrize("kwargs", [{"ssf": True}, {"vpt_len": 5}])
def test_unported_vit_variants_raise(kwargs):
    """SSF and VPT-deep are not in the port: the factory refuses them (the
    JAX factory builds them), citing its ROADMAP item."""
    jvit.vit_tiny_test(**kwargs)
    with pytest.raises(NotImplementedError, match="item 9"):
        tvit.vit_tiny_test(**kwargs)


def test_moe_vit_refuses_capture():
    tm = tvit.VisionTransformer(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=2,
                                moe_experts=2, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="capture"):
        tm(torch.rand(1, 16, 16, 3), capture=True)
