"""The port's L2P against the JAX package's: the prompt-pool selection with
forced ties, the loss and its gradients with respect to the prompts and the
head, and one train step (global-norm clip + Adam) at the same lr, all in
float32 on ``vit_tiny_test`` from the same weights and uint8 batch."""

from __future__ import annotations

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.methods import prompt_methods as jpm  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import prompt_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.methods import prompt_methods as tpm  # noqa: E402

#: float32 on the CPU through a 4-block ViT: summation order only
TOL = 1e-5
GRAD_TOL = 1e-4

OVERRIDES = {
    "dataset": "synthetic", "data_root": "", "image_size": 32,
    "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4, "epoch": 1,
    "batch_size": 8, "seed": 3, "dtype": "float32", "augment": False,
    "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "vit_tiny_test", "kwargs": {}},
    "classifier": {"name": "L2P", "kwargs": {
        "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4,
        "task_num": 2, "prompt_length": 3, "pool_size": 6, "top_k": 3,
        "pull_constraint_coeff": 0.5}},
    "train_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
    "test_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
    "optimizer": {"name": "Adam", "kwargs": {"lr": 0.01}},
}


class _Pool(torch.nn.Module):
    def __init__(self, prompt, key):
        super().__init__()
        self.prompt = torch.nn.Parameter(torch.from_numpy(prompt))
        self.key = torch.nn.Parameter(torch.from_numpy(key))


@pytest.mark.parametrize("weighted", [False, True])
def test_pool_forward_breaks_ties_like_jax(weighted):
    rng = np.random.RandomState(0)
    m, d, b = 6, 8, 5
    base = rng.rand(3, d).astype(np.float32)
    key = np.concatenate([base, base])  # every key twice: tied similarities
    prompt = rng.rand(m, 2, d).astype(np.float32)
    q = rng.rand(b, d).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1], np.float32) if weighted else None
    jb, jsim = jpm.l2p_pool_forward(
        {"prompt": jnp.asarray(prompt), "key": jnp.asarray(key)}, jnp.asarray(q), 3,
        None if w is None else jnp.asarray(w),
    )
    tb, tsim = tpm.l2p_pool_forward(
        _Pool(prompt, key), torch.from_numpy(q), 3, None if w is None else torch.from_numpy(w)
    )
    np.testing.assert_array_equal(tb.detach().numpy(), np.asarray(jb))
    np.testing.assert_allclose(float(tsim.detach()), float(jsim), atol=TOL, rtol=TOL)


def test_top_k_takes_the_lower_index_on_ties():
    counts = torch.tensor([2.0, 5.0, 2.0, 5.0, 0.0, 2.0])
    assert tpm._top_k_indices(counts, 4).tolist() == [1, 3, 0, 2]
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray(counts.numpy()), 4)[1]), [1, 3, 0, 2]
    )


@functools.lru_cache(maxsize=1)
def _jax_side():
    jcfg = JaxConfig(overrides=copy.deepcopy(OVERRIDES)).get_config_dict()
    jm = jpm.L2P(jcfg)
    return jm, jm.init_state(jax.random.PRNGKey(4), (32, 32, 3))


def _pair():
    """The JAX method and state (built once per module: JAX's eager init
    is slow) and a fresh port state holding the same weights."""
    jm, jstate = _jax_side()
    tcfg = Config(overrides=copy.deepcopy(OVERRIDES)).get_config_dict()
    tm = tpm.L2P(tcfg, "cpu")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tstate = prompt_state_from_flax(tm, tree(jstate.params), tree(jstate.mvars["frozen"]))
    rng = np.random.RandomState(5)
    batch = {
        "image": rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
        "label": rng.randint(0, 4, (8,)).astype(np.int32),
        "weight": np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32),
    }
    return jm, jstate, tm, tstate, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {"image": torch.from_numpy(batch["image"]),
            "label": torch.from_numpy(batch["label"].astype(np.int64)),
            "weight": torch.from_numpy(batch["weight"])}


def test_loss_and_grads_match_jax():
    jm, jstate, tm, tstate, batch = _pair()
    jb = _jbatch(batch)
    jb["x"] = jm.augment(None, jb["image"], train=False)
    loss_fn = lambda p, st, b: jm.loss(p, st, b, jax.random.PRNGKey(0))  # noqa: E731
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate, jb)

    tb = _tbatch(batch)
    tb["x"] = tm.augment(None, tb["image"], train=False)
    tloss, aux = tm.loss(tstate, tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=TOL, rtol=TOL)
    head, pool = tstate.params["head"].dense, tstate.params["prompt"]
    pairs = [
        (head.weight.grad.T, jgrads["head"]["Dense_0"]["kernel"]),
        (head.bias.grad, jgrads["head"]["Dense_0"]["bias"]),
        (pool.prompt.grad, jgrads["prompt"]["prompt"]),
        (pool.key.grad, jgrads["prompt"]["key"]),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=GRAD_TOL, rtol=GRAD_TOL)
    assert all(p.grad is None for p in tstate.mvars["frozen"].parameters())


def test_train_step_matches_jax():
    jm, jstate, tm, tstate, batch = _pair()
    lr = 0.01
    jnew, jmet = jax.jit(jm.train_step)(jstate, _jbatch(batch), jnp.float32(lr))
    tstate, tmet = tm.train_step(tstate, _tbatch(batch), lr)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=TOL, rtol=TOL)
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]))
    assert tstate.step == 1
    head, pool = tstate.params["head"].dense, tstate.params["prompt"]
    jp = jnew.params
    pairs = [
        (head.weight.T, jp["head"]["Dense_0"]["kernel"]),
        (head.bias, jp["head"]["Dense_0"]["bias"]),
        (pool.prompt, jp["prompt"]["prompt"]),
        (pool.key, jp["prompt"]["key"]),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL, rtol=TOL)


def test_eval_step_matches_jax():
    jm, jstate, tm, tstate, batch = _pair()
    jpred = jax.jit(jm.eval_step)(jstate, _jbatch(batch), jnp.int32(-1))
    tpred = tm.eval_step(tstate, _tbatch(batch), -1)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
