"""The port's MoE-Adapter4CL and RAPF against the JAX package's, in float32
on ``clip_tiny_test`` from the same weights and uint8 batch:

  * MoE-Adapter4CL: the loss and its gradients with respect to every MoE
    leaf and ``logit_scale``, one train step (Adam), the eval logits, at
    task 0 and task 1; the experts' gate noise and dropout are off on both
    sides (the JAX state's loss gets no rng, the port's no generator), since
    the two frameworks cannot draw the same numbers;
  * RAPF: ``before_task`` (text features, hard pairs, replay order), the
    loss and its adapter gradient with the JAX draws of replay and edge noise
    fed to the port, and ``after_task`` (class means, Cholesky factors, the
    ``mix_matrix`` fusion)."""

from __future__ import annotations

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.methods import clip_methods as jcm  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import MOE_LEAVES, clip_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.methods import clip_methods as tcm  # noqa: E402

#: float32 on the CPU through 2 + 2 blocks: summation order only
TOL = 1e-5
GRAD_TOL = 1e-4
#: Adam's first step is ``lr * g / (|g| + eps)``: lr 1e-3 and eps 1e-6 keep
#: a near-zero gradient element's sum-order noise below ~1e-6 of movement
LR, ADAM_EPS = 1e-3, 1e-6


def _overrides(name):
    kwargs = {"beta": 0.5} if name == "RAPF" else {}
    backbone = {"moe_experts": 2, "moe_text_gate": "eot"} if name == "MOE_ADAPTER4CL" else {}
    return {
        "dataset": "synthetic", "data_root": "", "image_size": 32,
        "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4, "epoch": 1,
        "batch_size": 8, "seed": 3, "dtype": "float32",
        "mesh": {"data": 1, "model": 1},
        "backbone": {"name": "clip_tiny_test", "kwargs": backbone},
        "classifier": {"name": name, "kwargs": {
            "num_class": 8, "feat_dim": 32, "init_cls_num": 4, "inc_cls_num": 4,
            "task_num": 2, **kwargs}},
        "optimizer": {"name": "Adam", "kwargs": {"lr": LR, "eps": ADAM_EPS}},
    }


def _tree(t):
    return jax.tree_util.tree_map(np.array, jax.device_get(t))


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """The JAX method and its initial state (built once: JAX's init is
    slow). MoE-Adapter4CL's experts get random values: at init ``up`` and
    the routers are zero, which would hide most gradients."""
    jcfg = JaxConfig(overrides=copy.deepcopy(_overrides(name))).get_config_dict()
    jm = jcm.MoEAdapter4CL(jcfg) if name == "MOE_ADAPTER4CL" else jcm.RAPF(jcfg)
    state = jm.init_state(jax.random.PRNGKey(4), (32, 32, 3))
    if name == "MOE_ADAPTER4CL":
        params = _tree(state.params)
        rng = np.random.RandomState(6)
        for tower in ("visual", "text"):
            for blk in params["clip"][tower].values():
                for leaf in MOE_LEAVES:
                    a = blk["moe"][leaf]
                    blk["moe"][leaf] = (rng.randn(*a.shape) * 0.2).astype(np.float32)
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                              opt_state=jm._tx_for_task(0).init(params))
    return jm, state


def _task_data(rng, lo, hi, per_class=5):
    labels = np.repeat(np.arange(lo, hi), per_class).astype(np.int32)
    images = rng.randint(0, 256, (len(labels), 32, 32, 3)).astype(np.uint8)
    return types.SimpleNamespace(images=images, labels=labels)


TASK_DATA = {t: _task_data(np.random.RandomState(10 + t), 4 * t, 4 * t + 4) for t in (0, 1)}


def _pair(name, task):
    """JAX and port method and state with the same weights, advanced through
    ``start_task`` / ``before_task`` (and, for RAPF, ``after_task`` of the
    earlier task) up to ``task``."""
    jm, jstate = _jax_side(name)
    tcfg = Config(overrides=copy.deepcopy(_overrides(name))).get_config_dict()
    tm = (tcm.MoEAdapter4CL if name == "MOE_ADAPTER4CL" else tcm.RAPF)(tcfg, "cpu")
    tstate = clip_state_from_flax(tm, _tree(jstate.params), _tree(jstate.mvars))
    for t in range(task + 1):
        lo, hi = 4 * t, 4 * t + 4
        jstate = jm.before_task(jm.start_task(jstate, t, lo, hi), t, TASK_DATA[t])
        tstate = tm.before_task(tm.start_task(tstate, t, lo, hi), t, TASK_DATA[t])
        if t < task:
            jstate = jm.after_task(jstate, t, TASK_DATA[t])
            tstate = tm.after_task(tstate, t, TASK_DATA[t])
    rng = np.random.RandomState(5)
    batch = {
        "image": rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
        "label": rng.randint(4 * task, 4 * task + 4, (8,)).astype(np.int32),
        "weight": np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32),
    }
    return jm, jstate, tm, tstate, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {"image": torch.from_numpy(batch["image"]),
            "label": torch.from_numpy(batch["label"].astype(np.int64)),
            "weight": torch.from_numpy(batch["weight"])}


def _moe_trainables(tstate, jparams):
    """(port tensor, JAX array, name) for every MoE leaf and ``logit_scale``."""
    clip = tstate.params["clip"]
    pairs = [(clip.logit_scale, jparams["clip"]["logit_scale"], "logit_scale")]
    for tower, mod in (("visual", clip.visual), ("text", clip.text)):
        for i, blk in enumerate(mod.blocks):
            for leaf in MOE_LEAVES:
                pairs.append((getattr(blk.moe, leaf),
                              jparams["clip"][tower][f"block_{i}"]["moe"][leaf],
                              f"{tower}.block_{i}.moe.{leaf}"))
    return pairs


def _no_moe_draws(jm, tm):
    """Noise and dropout off on both sides, for this test's objects only."""
    apply = jm._apply
    jm_off = copy.copy(jm)
    jm_off._apply = lambda params, mvars, images, tokens, train, rng=None: apply(
        params, mvars, images, tokens, train, None)
    tm.moe_generator = lambda state: None
    return jm_off


def test_moe_trainable_split_equals_jax():
    jm, jstate, tm, tstate, _ = _pair("MOE_ADAPTER4CL", 0)
    trainable = {n for n, p in tstate.params.named_parameters() if p.requires_grad}
    assert len(trainable) == len(jax.tree_util.tree_leaves(jstate.params)) == 1 + 4 * 6
    assert trainable == {f"clip.{name}".replace(".block_", ".blocks.")
                         for _, _, name in _moe_trainables(tstate, _tree(jstate.params))}
    opt_params = [p for g in tstate.opt_state.param_groups for p in g["params"]]
    assert len(opt_params) == len(trainable)
    np.testing.assert_array_equal(tstate.mvars["task_tokens"].numpy(),
                                  np.asarray(jstate.mvars["task_tokens"]))


@pytest.mark.parametrize("task", [0, 1])
def test_moe_loss_and_grads_match_jax(task):
    jm, jstate, tm, tstate, batch = _pair("MOE_ADAPTER4CL", task)
    jb = _jbatch(batch)
    jb["x"] = jm.augment(None, jb["image"], train=False)
    loss_fn = lambda p, st, b: jm.loss(p, st, b, None)  # noqa: E731
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate, jb)
    tm.moe_generator = lambda state: None
    tb = _tbatch(batch)
    tb["x"] = tm.augment(None, tb["image"], train=False)
    tloss, _ = tm.loss(tstate, tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=TOL, rtol=TOL)
    for t, j, label in _moe_trainables(tstate, _tree(jgrads)):
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), j, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=label)
    frozen = [p for p in tstate.params.parameters() if not p.requires_grad]
    assert frozen and all(p.grad is None for p in frozen)


@pytest.mark.parametrize("task", [0, 1])
def test_moe_train_step_matches_jax(task):
    jm, jstate, tm, tstate, batch = _pair("MOE_ADAPTER4CL", task)
    jm_off = _no_moe_draws(jm, tm)
    jnew, jmet = jax.jit(jm_off.train_step)(jstate, _jbatch(batch), jnp.float32(LR))
    tstate, tmet = tm.train_step(tstate, _tbatch(batch), LR)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=TOL, rtol=TOL)
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]))
    for t, j, label in _moe_trainables(tstate, _tree(jnew.params)):
        np.testing.assert_allclose(t.detach().numpy(), j, atol=TOL, rtol=TOL, err_msg=label)


@pytest.mark.parametrize("task", [0, 1])
def test_moe_eval_logits_match_jax(task):
    jm, jstate, tm, tstate, batch = _pair("MOE_ADAPTER4CL", task)
    x = jm.augment(None, jnp.asarray(batch["image"]), train=False)
    jlog = np.asarray(jax.jit(jm.eval_logits, static_argnums=2)(jstate, x, -1))
    tlog = tm.eval_logits(tstate, torch.from_numpy(np.array(x)), -1).detach().numpy()
    seen = 4 * task + 4
    np.testing.assert_allclose(tlog[:, :seen], jlog[:, :seen], atol=TOL, rtol=TOL)
    assert (tlog[:, seen:] == -1e30).all() and (jlog[:, seen:] == -1e30).all()


def test_rapf_before_task_matches_jax():
    jm, jstate, tm, tstate, _ = _pair("RAPF", 1)
    np.testing.assert_allclose(tstate.mvars["text_feats"].numpy(),
                               np.asarray(jstate.mvars["text_feats"]), atol=TOL, rtol=TOL)
    for key in ("replay_order", "hard_old", "hard_new", "hard_valid"):
        np.testing.assert_array_equal(tstate.mvars[key].numpy(), np.asarray(jstate.mvars[key]),
                                      err_msg=key)
    assert tstate.mvars["replay_len"] == int(jstate.mvars["replay_len"]) == 4


@pytest.mark.parametrize("task", [0, 1])
def test_rapf_loss_with_jax_noise_matches_jax(task):
    """The port's loss takes the replay and edge noise as tensors; the test
    draws them from the key the JAX loss splits."""
    jm, jstate, tm, tstate, batch = _pair("RAPF", task)
    key = jax.random.PRNGKey(9)
    k_replay, k_edge = jax.random.split(key)
    noise = (np.array(jax.random.normal(k_replay, (tm.replay_cpb, tm.replay_per_cls, 32))),
             np.array(jax.random.normal(k_edge, (tm.hard_cap, tm.edge_per_pair, 32))))
    jb = _jbatch(batch)
    jb["x"] = jm.augment(None, jb["image"], train=False)
    loss_fn = lambda p, st, b: jm.loss(p, st, b, key)  # noqa: E731
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate, jb)
    tb = _tbatch(batch)
    tb["x"] = tm.augment(None, tb["image"], train=False)
    tloss, _ = tm.loss(tstate, tb, noise=tuple(torch.from_numpy(n) for n in noise))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=TOL, rtol=TOL)
    j = np.asarray(jgrads["adapter"]["kernel"])
    assert np.linalg.norm(j) > 100 * GRAD_TOL
    np.testing.assert_allclose(tstate.params["adapter"]["kernel"].grad.numpy(), j,
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    if task == 1:  # the replayed features and the hinge are in the loss
        assert float(jstate.mvars["hard_valid"].sum()) > 0


def test_rapf_after_task_matches_jax():
    """Task 0's statistics, then task 1's and the fusion of a moved adapter
    (the same random kernel on both sides) with task 0's."""
    jm, jstate, tm, tstate, _ = _pair("RAPF", 0)
    jstate = jm.after_task(jstate, 0, TASK_DATA[0])
    tstate = tm.after_task(tstate, 0, TASK_DATA[0])
    jstate = jm.before_task(jm.start_task(jstate, 1, 4, 8), 1, TASK_DATA[1])
    tstate = tm.before_task(tm.start_task(tstate, 1, 4, 8), 1, TASK_DATA[1])
    moved = np.random.RandomState(8).randn(32, 32).astype(np.float32) * 0.2
    jstate = jstate.replace(params={"adapter": {"kernel": jnp.asarray(moved)}})
    with torch.no_grad():
        tstate.params["adapter"]["kernel"].copy_(torch.from_numpy(moved))
    jstate = jm.after_task(jstate, 1, TASK_DATA[1])
    tstate = tm.after_task(tstate, 1, TASK_DATA[1])
    for key in ("cls_mean", "cls_chol", "cls_valid"):
        np.testing.assert_allclose(tstate.mvars[key].numpy(), np.asarray(jstate.mvars[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    assert float(tstate.mvars["cls_valid"].sum()) == 8.0
    fused_j = np.asarray(jstate.params["adapter"]["kernel"])
    assert not np.allclose(fused_j, moved, atol=1e-3)  # the fusion moved it back
    np.testing.assert_allclose(tstate.params["adapter"]["kernel"].detach().numpy(), fused_j,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tstate.mvars["old_adapter"]["kernel"].numpy(),
                                  tstate.params["adapter"]["kernel"].detach().numpy())


def test_shrink_cov_and_mix_matrix_equal_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(6, 6)
    cov = a @ a.T + 0.1 * np.eye(6)
    np.testing.assert_array_equal(tcm.shrink_cov(cov), jcm.shrink_cov(cov))
    w_old, w_new = rng.randn(6, 6), rng.randn(6, 6)
    np.testing.assert_array_equal(tcm.mix_matrix(w_old, w_new, 0.3),
                                  jcm.mix_matrix(w_old, w_new, 0.3))


def test_moe_adapter_on_a_vit_is_not_ported():
    cfg = Config(overrides={**_overrides("MOE_ADAPTER4CL"),
                            "backbone": {"name": "vit_tiny_test", "kwargs": {}}}).get_config_dict()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcm.make_moe_adapter4cl(cfg, "cpu")


@pytest.mark.parametrize("name,path", [("MoE_Adapter4CL", "moe_adapter4cl.yaml"),
                                       ("RAPF", "rapf10-10.yaml")])
def test_chip_smoke_configs_equal_the_shipped_yaml(name, path):
    """``chip_smoke.py`` passes the shipped configs as dicts (the card's
    machine need not have PyYAML): each setting equals the YAML file's."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    shipped = Config(os.path.join(repo, "configs", path)).get_config_dict()
    for key, value in chip_smoke.CLIP_CONFIGS[name].items():
        if key in ("dataset", "data_root", "dtype", "mesh"):
            continue  # synthetic data on the card; the bf16 and mesh defaults
        assert shipped[key] == value, key


@pytest.mark.parametrize("masked", [False, True])
def test_label_smoothing_equals_jax(masked):
    """MoE-Adapter4CL's ``label_smoothing`` option: the smoothed CE over the
    unmasked classes, as the JAX package computes it."""
    from libcontinual_tpu.core.method import masked_cross_entropy as jce
    from libcontinual_tpu_torch.core.method import masked_cross_entropy as tce

    rng = np.random.RandomState(3)
    logits = rng.randn(6, 8).astype(np.float32)
    labels = rng.randint(0, 4, 6)
    weight = np.array([1, 1, 1, 1, 0, 1], np.float32)
    mask = (np.arange(8) < 4).astype(np.float32) if masked else None
    want = jce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weight),
               None if mask is None else jnp.asarray(mask), 0.1)
    got = tce(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(weight),
              None if mask is None else torch.from_numpy(mask), 0.1)
    np.testing.assert_allclose(float(got), float(want), atol=TOL, rtol=TOL)
