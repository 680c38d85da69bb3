"""The port's DualPrompt, CODA-Prompt and DAP against the JAX package's: the
loss and its gradients with respect to the head and every prompt tensor,
one train step (global-norm clip + Adam), the eval predictions, CODA's
Gram-Schmidt pool and DAP's task-boundary anchors, in float32 on
``vit_tiny_test`` from the same weights and uint8 batch, at task 0 and at
task 1 (after ``start_task`` and ``before_task`` on both sides)."""

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
from libcontinual_tpu.methods import dap as jdap  # noqa: E402
from libcontinual_tpu.methods import prompt_methods as jpm  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import prompt_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.methods import dap as tdap  # noqa: E402
from libcontinual_tpu_torch.methods import prompt_methods as tpm  # noqa: E402

#: float32 on the CPU through a 4-block ViT: summation order only
TOL = 1e-5
GRAD_TOL = 1e-4
#: Adam's first step is ``lr * g / (|g| + eps)``: where a gradient element
#: is near zero (|g| ~ 1e-7, or exactly 0 on one side), the two frameworks'
#: sum-order differences of ~1e-9 become a relative error that this step
#: turns into up to ``lr`` of difference. The step test takes lr 1e-3 and
#: eps 1e-6, so that such an element moves the parameters by at most ~1e-6.
LR, ADAM_EPS = 1e-3, 1e-6

KWARGS = {
    "DualPrompt": {"e_prompt_length": 4, "g_prompt_length": 2, "pool_size": 2},
    "CodaPrompt": {"prompt_length": 4, "pool_size": 4, "mu": 0.1},
    "DAP": {"length": 3, "top_k": 1},
}
CLASSES = {
    "DualPrompt": (jpm.DualPrompt, tpm.DualPrompt),
    "CodaPrompt": (jpm.CodaPrompt, tpm.CodaPrompt),
    "DAP": (jdap.DAP, tdap.DAP),
}
#: task sizes handed to ``before_task`` (DAP reads only their lengths)
TASK_DATA = (range(30), range(50))
CASES = [(name, task) for name in KWARGS for task in (0, 1)]


def _overrides(name):
    return {
        "dataset": "synthetic", "data_root": "", "image_size": 32,
        "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4, "epoch": 1,
        "batch_size": 8, "seed": 3, "dtype": "float32", "augment": False,
        "mesh": {"data": 1, "model": 1},
        "backbone": {"name": "vit_tiny_test", "kwargs": {}},
        "classifier": {"name": name, "kwargs": {
            "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4,
            "task_num": 2, **KWARGS[name]}},
        "train_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
        "test_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
        "optimizer": {"name": "Adam", "kwargs": {"lr": LR, "eps": ADAM_EPS}},
    }


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    jcfg = JaxConfig(overrides=copy.deepcopy(_overrides(name))).get_config_dict()
    jm = CLASSES[name][0](jcfg)
    return jm, jm.init_state(jax.random.PRNGKey(4), (32, 32, 3))


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(name, task):
    """The JAX method and state (initial state built once per method: JAX's
    eager init is slow), and a fresh port method and state holding the same
    weights, both advanced through ``start_task`` / ``before_task`` up to
    ``task``."""
    jm, jstate = _jax_side(name)
    if name == "DAP":
        jm._task_counts = []
    tcfg = Config(overrides=copy.deepcopy(_overrides(name))).get_config_dict()
    tm = CLASSES[name][1](tcfg, "cpu")
    tstate = prompt_state_from_flax(tm, _tree(jstate.params), _tree(jstate.mvars["frozen"]))
    for t in range(task + 1):
        lo, hi = (0, 4) if t == 0 else (4, 8)
        jstate = jm.before_task(jm.start_task(jstate, t, lo, hi), t, TASK_DATA[t])
        tstate = tm.before_task(tm.start_task(tstate, t, lo, hi), t, TASK_DATA[t])
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


def _trainables(tstate, jparams):
    """(port tensor, JAX array) pairs: the head and every prompt tensor."""
    head = tstate.params["head"].dense
    pairs = [(head.weight, jparams["head"]["Dense_0"]["kernel"].T, "head.kernel"),
             (head.bias, jparams["head"]["Dense_0"]["bias"], "head.bias")]
    for name, t in tstate.params["prompt"].items():
        pairs.append((t, jparams["prompt"][name], f"prompt.{name}"))
    return pairs


@pytest.mark.parametrize("name,task", CASES)
def test_loss_and_grads_match_jax(name, task):
    jm, jstate, tm, tstate, batch = _pair(name, task)
    jb = _jbatch(batch)
    jb["x"] = jm.augment(None, jb["image"], train=False)
    loss_fn = lambda p, st, b: jm.loss(p, st, b, jax.random.PRNGKey(0))  # noqa: E731
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, jstate, jb)

    tb = _tbatch(batch)
    tb["x"] = tm.augment(None, tb["image"], train=False)
    tloss, _ = tm.loss(tstate, tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=TOL, rtol=TOL)
    for t, j, label in _trainables(tstate, jgrads):
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(grad.numpy(), np.asarray(j), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=label)
    assert all(p.grad is None for p in tstate.mvars["frozen"].parameters())


@pytest.mark.parametrize("name,task", CASES)
def test_train_step_matches_jax(name, task):
    jm, jstate, tm, tstate, batch = _pair(name, task)
    jnew, jmet = jax.jit(jm.train_step)(jstate, _jbatch(batch), jnp.float32(LR))
    tstate, tmet = tm.train_step(tstate, _tbatch(batch), LR)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=TOL, rtol=TOL)
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]))
    for t, j, label in _trainables(tstate, jnew.params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL, rtol=TOL,
                                   err_msg=label)


@pytest.mark.parametrize("name,task", CASES)
def test_eval_step_matches_jax(name, task):
    jm, jstate, tm, tstate, batch = _pair(name, task)
    jpred = jax.jit(jm.eval_step)(jstate, _jbatch(batch), jnp.int32(-1))
    tpred = tm.eval_step(tstate, _tbatch(batch), -1)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))


def test_dualprompt_eval_prefixes_take_each_images_key():
    """In evaluation each image takes the e-prompt of its best-matching key,
    so the prefix rows differ across the batch; in training every image
    takes the task's prompt."""
    jm, jstate, tm, tstate, _ = _pair("DualPrompt", 0)
    prompt = tstate.params["prompt"]
    q = torch.stack([prompt["e_k_2"][1], prompt["e_k_2"][0], prompt["e_k_2"][1]]).detach()
    jprompt = jax.tree_util.tree_map(jnp.asarray, _tree(jstate.params["prompt"]))
    for train in (False, True):
        tkv, tmatch = tm.prefixes(prompt, q, 1, train)
        jkv, jmatch = jm._prefixes(jprompt, jnp.asarray(q.numpy()), jnp.int32(1), train)
        for layer in jkv:
            for t, j in zip(tkv[layer], jkv[layer]):
                np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL, rtol=0)
        np.testing.assert_allclose(float(tmatch), float(jmatch), atol=TOL, rtol=TOL)
    pk_eval = tm.prefixes(prompt, q, 1, False)[0][2][0]
    assert not torch.equal(pk_eval[0], pk_eval[1]) and torch.equal(pk_eval[0], pk_eval[2])


def test_coda_pool_and_before_task_rows_equal_jax():
    jm, jstate, tm, tstate, _ = _pair("CodaPrompt", 0)
    fresh = tm.init_prompt_params(None)
    for name, t in fresh.items():
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(jstate.params["prompt"][name]))
    jstate = jm.before_task(jm.start_task(jstate, 1, 4, 8), 1, TASK_DATA[1])
    tstate = tm.before_task(tm.start_task(tstate, 1, 4, 8), 1, TASK_DATA[1])
    for name, t in tstate.params["prompt"].items():
        j = np.asarray(jstate.params["prompt"][name])
        np.testing.assert_array_equal(t.detach().numpy(), j, err_msg=name)
        rows = j.reshape(j.shape[0], -1)[:4]  # tasks 0 and 1: two rows each
        np.testing.assert_allclose(rows @ rows.T, np.eye(4), atol=1e-5, err_msg=name)


def test_coda_before_task_keeps_the_optimizer_parameters():
    _, _, tm, tstate, _ = _pair("CodaPrompt", 0)
    before = {n: (t, t.detach().clone()) for n, t in tstate.params["prompt"].items()}
    tstate = tm.before_task(tm.start_task(tstate, 1, 4, 8), 1, TASK_DATA[1])
    for name, t in tstate.params["prompt"].items():
        obj, old = before[name]
        assert t is obj  # the optimizer's Parameter objects stay the same
        assert torch.equal(t[:2].detach(), old[:2]) and not torch.equal(t[2:4].detach(), old[2:4])


def test_dap_anchors_after_two_before_task_calls_equal_jax():
    jm, jstate, tm, tstate, _ = _pair("DAP", 1)
    np.testing.assert_array_equal(float(tstate.mvars["alpha"]), float(jstate.mvars["alpha"]))
    np.testing.assert_array_equal(tstate.mvars["prompt_center"].numpy(),
                                  np.asarray(jstate.mvars["prompt_center"]))
    assert float(tstate.mvars["alpha"]) == 1.0  # the newest task is the largest
    assert tm._task_counts == [30, 50]
