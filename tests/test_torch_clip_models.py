"""The port's CLIP against the JAX package's, in float32 on the CPU:
``MoEMLP`` with the JAX draws of gate noise and expert dropout fed in (and
with neither, the zero-router tie included), both towers and the whole
``clip_tiny_test`` model (features, logits, ``moe_aux``), the gradient of a
random projection of the logits with respect to the MoE leaves and
``logit_scale``, and ``load_clip_torch_weights`` on a synthetic
OpenAI-style state dict."""

from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.models import clip as jclip  # noqa: E402
from libcontinual_tpu.models import vit as jvit  # noqa: E402
from libcontinual_tpu.models.tokenizer import tokenize  # noqa: E402
from libcontinual_tpu_torch import convert  # noqa: E402
from libcontinual_tpu_torch.models import clip as tclip  # noqa: E402
from libcontinual_tpu_torch.models import vit as tvit  # noqa: E402

#: float32 on the CPU: the same arithmetic in another summation order,
#: through 2 + 2 blocks
TOL = 1e-4
#: a leaf's gradient error over its largest entry: f32 sum order only
GRAD_REL_TOL = 1e-3
PROMPTS = ["a photo of a class 0.", "a photo of a cat", "two dogs, running!", "x"]


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _moe_params(rng, d, e, k, zero_router=False):
    p = {
        "w_gate": rng.randn(d, e) * 0.5, "w_noise": rng.randn(d, e) * 0.5,
        "down": rng.randn(e, d, k) * 0.2, "down_b": rng.randn(e, k) * 0.1,
        "up": rng.randn(e, k, d) * 0.2, "up_b": rng.randn(e, d) * 0.1,
    }
    if zero_router:
        p["w_gate"] = np.zeros((d, e))
    return {n: a.astype(np.float32) for n, a in p.items()}


def _port_moe(p, e, top_k, k):
    m = tvit.MoEMLP(p["w_gate"].shape[0], e, top_k, bottleneck=k, dtype=torch.float32)
    for name in convert.MOE_LEAVES:
        getattr(m, name).data.copy_(torch.from_numpy(p[name]))
    return m


@pytest.mark.parametrize("draws", [False, True])
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_mlp_matches_jax(draws, zero_router):
    """With ``draws`` the test rebuilds the JAX draws from one key, split
    into noise and dropout keys as ``ViTBlock`` splits its ``moe_rng``."""
    b, s, d, e, top_k, k = 3, 5, 16, 4, 2, 8
    rng = np.random.RandomState(0)
    p = _moe_params(rng, d, e, k, zero_router)
    x = rng.randn(b, s, d).astype(np.float32)
    gvec = rng.randn(b, d).astype(np.float32)
    jm = jvit.MoEMLP(d, e, top_k, bottleneck=k, dtype=jnp.float32)
    noise_rng = drop_rng = None
    noise = keep = None
    if draws:
        noise_rng, drop_rng = jax.random.split(jax.random.PRNGKey(3))
        noise = torch.from_numpy(np.array(jax.random.normal(noise_rng, (b, e))))
        keep = torch.from_numpy(np.array(jax.random.bernoulli(drop_rng, 0.9, (b, s, e, k))))

    def jfn(pp, x):
        out, cv2 = jm.apply({"params": pp}, x, gate_noise_rng=noise_rng, gate_vec=jnp.asarray(gvec),
                            dropout_rng=drop_rng)
        return out, cv2

    out_j, cv2_j = jfn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tm = _port_moe(p, e, top_k, k)
    out_t, cv2_t = tm(torch.from_numpy(x), torch.from_numpy(gvec), noise, keep)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(cv2_t.detach()), float(cv2_j), atol=1e-5, rtol=1e-5)
    if zero_router and not draws:
        # every logit ties at 0: both pick experts 0 and 1 with gates 1/2
        gates = tvit.top_k_gates(torch.zeros(b, e), top_k)
        assert torch.equal(gates, torch.tensor([[0.5, 0.5, 0.0, 0.0]] * b))


def test_moe_draws_have_the_right_rates():
    m = tvit.MoEMLP(8, 4, 2, bottleneck=16, dtype=torch.float32)
    noise, keep = m.draws(torch.zeros(64, 50, 8), torch.Generator().manual_seed(0))
    assert noise.shape == (64, 4) and keep.shape == (64, 50, 4, 16) and keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    assert abs(float(noise.std()) - 1.0) < 0.1


@functools.lru_cache(maxsize=None)
def _jax_init(moe_experts):
    """The JAX model's initial weights (the same for either text gate)."""
    jm = jclip.clip_tiny_test(moe_experts=moe_experts, dtype=jnp.float32)
    init = jax.jit(lambda k, x, t: jm.init(k, x, t, train=False))
    return _tree(init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                      jnp.asarray(tokenize(PROMPTS)))["params"])


def _clip_pair(moe_experts=2, moe_text_gate="eot"):
    """JAX and port ``clip_tiny_test`` in f32 with the same weights; the MoE
    leaves are random (the zero-init ``up`` would hide the experts)."""
    jm = jclip.clip_tiny_test(moe_experts=moe_experts, moe_text_gate=moe_text_gate,
                              dtype=jnp.float32)
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    toks = tokenize(PROMPTS)
    params = copy.deepcopy(_jax_init(moe_experts))
    rng = np.random.RandomState(2)
    for tower in ("visual", "text"):
        for name, blk in params[tower].items():
            if name.startswith("block_") and "moe" in blk:
                blk["moe"] = _moe_params(rng, 64, moe_experts, 64)
    tm = tclip.clip_tiny_test(moe_experts=moe_experts, moe_text_gate=moe_text_gate,
                              dtype=torch.float32)
    convert.load_clip(tm, params)
    return jm, params, tm, x, toks


@pytest.mark.parametrize("gate", ["eot", "sot"])
def test_clip_tiny_matches_jax(gate):
    jm, params, tm, x, toks = _clip_pair(moe_text_gate=gate)
    out_j = jax.jit(lambda p, x, t: jm.apply({"params": p}, x, t, train=False))(
        params, jnp.asarray(x), jnp.asarray(toks))
    out_t = tm(torch.from_numpy(x), torch.from_numpy(toks.astype(np.int64)))
    for key in ("image_features", "text_features", "logits_per_image", "moe_aux"):
        np.testing.assert_allclose(out_t[key].detach().numpy(), np.asarray(out_j[key]),
                                   atol=TOL, rtol=TOL, err_msg=key)
    # the text tower alone, before the normalisation
    feat_j = jm.apply({"params": params}, jnp.asarray(toks), train=False,
                      method=lambda m, t, train: m.encode_text(t, train=train))[0]
    feat_t = tm.encode_text(torch.from_numpy(toks.astype(np.int64)))[0]
    np.testing.assert_allclose(feat_t.detach().numpy(), np.asarray(feat_j), atol=TOL, rtol=TOL)


def test_clip_without_experts_matches_jax():
    jm, params, tm, x, toks = _clip_pair(moe_experts=0)
    out_j = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(toks), train=False)
    out_t = tm(torch.from_numpy(x), torch.from_numpy(toks.astype(np.int64)))
    np.testing.assert_allclose(out_t["logits_per_image"].detach().numpy(),
                               np.asarray(out_j["logits_per_image"]), atol=TOL, rtol=TOL)
    assert float(out_t["moe_aux"]) == 0.0


def test_moe_leaf_gradients_match_jax():
    """The gradient of a fixed random projection of the logits (the
    features are unit vectors, so a sum of their squares would be constant)
    with respect to every MoE leaf of both towers and ``logit_scale``."""
    jm, params, tm, x, toks = _clip_pair()
    u = np.random.RandomState(4).randn(3, len(PROMPTS)).astype(np.float32)

    def split(tree, path=()):
        train, frozen = {}, {}
        for k, v in tree.items():
            if isinstance(v, dict):
                t, f = split(v, path + (k,))
                if t:
                    train[k] = t
                if f:
                    frozen[k] = f
            elif any("moe" in q for q in path) or k == "logit_scale":
                train[k] = v
            else:
                frozen[k] = v
        return train, frozen

    train, frozen = split(jax.tree_util.tree_map(jnp.asarray, params))

    def objective(train):
        out = jm.apply({"params": convert.merge_trees(train, frozen)}, jnp.asarray(x),
                       jnp.asarray(toks), train=False)
        return jnp.sum(out["logits_per_image"] * jnp.asarray(u))

    grads_j = jax.jit(jax.grad(objective))(train)
    out_t = tm(torch.from_numpy(x), torch.from_numpy(toks.astype(np.int64)))
    (out_t["logits_per_image"] * torch.from_numpy(u)).sum().backward()
    np.testing.assert_allclose(tm.logit_scale.grad.numpy(), np.asarray(grads_j["logit_scale"]),
                               atol=TOL, rtol=TOL)
    n_leaves = 0
    for tower, mod in (("visual", tm.visual), ("text", tm.text)):
        for i, blk in enumerate(mod.blocks):
            for leaf in convert.MOE_LEAVES:
                j = np.asarray(grads_j[tower][f"block_{i}"]["moe"][leaf])
                g = getattr(blk.moe, leaf).grad  # w_noise: None, no noise in eval
                t = np.zeros_like(j) if g is None else g.numpy()
                if leaf in ("down", "up"):
                    # a gradient that the tolerance could not tell from zero tests nothing
                    assert np.linalg.norm(j) > 100 * TOL, (tower, i, leaf)
                # the router's gradients are small (~1e-5 an entry): each leaf
                # is held to its own scale
                scale = max(float(np.abs(j).max()), 1e-30)
                assert float(np.abs(t - j).max()) <= GRAD_REL_TOL * scale, (tower, i, leaf)
                n_leaves += 1
    assert n_leaves == 2 * 2 * len(convert.MOE_LEAVES)


def _openai_state_dict(rng, w=64, depth=2, embed=32):
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    sd = {
        "visual.proj": f32(w, embed), "text_projection": f32(w, embed),
        "logit_scale": np.float32(1.5),
        "token_embedding.weight": f32(49408, w), "positional_embedding": f32(77, w),
        "ln_final.weight": f32(w), "ln_final.bias": f32(w),
        "visual.conv1.weight": f32(w, 3, 8, 8), "visual.class_embedding": f32(w),
        "visual.positional_embedding": f32(17, w),
        "visual.ln_pre.weight": f32(w), "visual.ln_pre.bias": f32(w),
        "visual.ln_post.weight": f32(w), "visual.ln_post.bias": f32(w),
    }
    for prefix in ("visual.transformer", "transformer"):
        for i in range(depth):
            b = f"{prefix}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = f32(w), f32(w)
            sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"] = f32(3 * w, w), f32(3 * w)
            sd[f"{b}.attn.out_proj.weight"], sd[f"{b}.attn.out_proj.bias"] = f32(w, w), f32(w)
            sd[f"{b}.mlp.c_fc.weight"], sd[f"{b}.mlp.c_fc.bias"] = f32(4 * w, w), f32(4 * w)
            sd[f"{b}.mlp.c_proj.weight"], sd[f"{b}.mlp.c_proj.bias"] = f32(w, 4 * w), f32(w)
    return sd


def test_load_clip_torch_weights_matches_jax_loader(tmp_path):
    jm, params, _, _, _ = _clip_pair()
    sd = _openai_state_dict(np.random.RandomState(5))
    del sd["visual.ln_post.weight"], sd["visual.ln_post.bias"]  # missing: the model's values stay
    sd["visual.proj"] = sd["visual.proj"][:, :16]  # another shape is skipped
    loaded_j = _tree(jclip.load_clip_torch_weights(jax.tree_util.tree_map(jnp.asarray, params), sd))
    expect = tclip.clip_tiny_test(moe_experts=2, moe_text_gate="eot", dtype=torch.float32)
    convert.load_clip(expect, loaded_j)

    path = str(tmp_path / "clip.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    for source in (sd, path):
        got = tclip.clip_tiny_test(moe_experts=2, moe_text_gate="eot", dtype=torch.float32)
        convert.load_clip(got, params)
        tclip.load_clip_torch_weights(got, source)
        ref = expect.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, ref[k]), k
    assert torch.equal(got.visual.blocks[1].attn.qkv.weight,
                       torch.from_numpy(sd["visual.transformer.resblocks.1.attn.in_proj_weight"]))
    with pytest.raises(FileNotFoundError):
        tclip.load_clip_torch_weights(got, str(tmp_path / "missing.pt"))
