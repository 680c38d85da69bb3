"""The port's online methods (ER-ACE, ER-AML, OCM, PRAKA) against the JAX
package's, in float32 at 8x8, from the same weights and buffer (the JAX state
converted): ER on ``resnet18_AML`` (buffer capacity 16), OCM and PRAKA on
``tiny_cnn`` (OCM's ``proj_dim`` is ``feat_dim // 2`` = 16).

The two frameworks draw different random numbers, so every test rebuilds the
JAX side's keys (``train_step``'s ``split(rng, 3)``, then the loss's own
splits and ``post_update``'s ``split``), computes the JAX draws from them and
hands them to the port's draw seam (each method's ``draw``, patched on the
instance): the reservoir slots and eviction noise, the replay indices,
ER-AML's Gumbel noise, OCM's slice offsets, PRAKA's class, lambda, row and
sign. OCM's SimCLR pipeline cannot be switched off by config: on the JAX
instance and on the port's it is replaced by one deterministic function.

Held: the rotation expansion and the NT-Xent variants on shared inputs; the
reservoir and class-balanced adds bitwise (a batch with two writes to one slot
and a padded item among them); one step at task 0 and two at task 1 per method
(the loss, every gradient, then the parameters, the running statistics and
the buffer after the step); each ``after_task``. SGD with momentum: Adam's
normalised first update would turn float noise in near-zero gradients into
full-size steps.

Each step starts from the JAX state: after a step the port's parameters,
running statistics and buffer are held against the JAX ones, then replaced by
them. Without that, the second task-1 step starts from parameters about 1e-6
apart, and on ``resnet18_AML`` (about 10^5 ReLU inputs a forward) one of them
then often lies within that of 0 (5.2e-7 and 1.3e-6 were found): it flips on
one side and moves the gradients of the stem and block 0 by up to 4.2e-2,
while the port's agree with its own float64 run to 6e-6. From one state the
two sides agree to 4e-5 on seeds 0-3, as the batch seeds 0, 1 and 2 here."""

from __future__ import annotations

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import libcontinual_tpu.methods  # noqa: E402,F401
import libcontinual_tpu_torch.methods  # noqa: E402,F401
from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.data.continual import TaskData as JaxTaskData  # noqa: E402
from libcontinual_tpu.methods import er as jer  # noqa: E402
from libcontinual_tpu.methods import ocm as jocm  # noqa: E402
from libcontinual_tpu.registry import METHODS as JAX_METHODS  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import (  # noqa: E402
    load_backbone_params, load_method_state, named_like, resnet_state_from_flax)
from libcontinual_tpu_torch.data.continual import TaskData  # noqa: E402
from libcontinual_tpu_torch.methods import er, ocm  # noqa: E402
from libcontinual_tpu_torch.registry import METHODS  # noqa: E402

#: float32 losses (the classic methods' file's), relative to the loss where
#: it is above 1: PRAKA's task-1 losses near 360 are resolved to 3e-5 in f32
TOL = 1e-5
#: gradients, and one SGD step through the conv / BatchNorm layers
GRAD_TOL = 1e-4

CAP = 16
NORM = [{"Normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]}}]
OVERRIDES = {
    "dataset": "synthetic", "data_root": "", "image_size": 8, "task_num": 2,
    "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 8, "seed": 3, "dtype": "float32",
    "augment": False, "train_trfms": NORM, "test_trfms": NORM,
    "mesh": {"data": 1, "model": 1},
    "buffer": {"name": "ERBuffer", "kwargs": {"buffer_size": CAP, "batch_size": 8}},
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9}},
}
#: (backbone, feat_dim, classifier kwargs, buffer kwargs) of each case; the
#: class-balanced buffer and the in-batch mining run in the trainer lockstep
#: (``tests/test_torch_online_trainer.py``)
CASES = {
    "ERACE": ("resnet18_AML", 160, {"use_augs": False, "task_free": True}, {}),
    "ERAML": ("resnet18_AML", 160, {"use_augs": False, "task_free": True,
                                    "supcon_temperature": 0.1}, {}),
    "ERAML-balanced-minimal": ("resnet18_AML", 160, {
        "use_augs": False, "task_free": False, "supcon_temperature": 0.1,
        "use_minimal_selection": True}, {"strategy": "balanced", "balanced_sampling": True}),
    "OCM": ("tiny_cnn", 32, {"buffer_batch_size": 12}, {}),
    "PRAKA": ("tiny_cnn", 32, {}, {}),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def config(case, **over):
    backbone, feat, kwargs, buf = CASES[case]
    ov = copy.deepcopy(OVERRIDES)
    ov["backbone"] = {"name": backbone, "kwargs": {}}
    ov["buffer"]["kwargs"].update(buf)
    ov["classifier"] = {"name": case.split("-")[0], "kwargs": {
        "num_class": 8, "feat_dim": feat, "init_cls_num": 4, "inc_cls_num": 4, "task_num": 2,
        **kwargs}}
    ov.update(over)
    return ov


# ---------------------------------------------------------- the JAX draws


def jax_simclr(rng, x):
    """The deterministic stand-in for OCM's SimCLR pipeline (JAX side)."""
    return x[:, ::-1] * 0.8 + 0.1


def port_simclr(gen, x):
    return x.flip(1) * 0.8 + 0.1


def _randint(key, shape, hi):
    return jax.random.randint(key, shape, 0, jnp.asarray(hi, jnp.int32))


def _replay_draws(jm, key, n_seen, amt):
    if getattr(jm, "balanced_sampling", False):
        k1, k2 = jax.random.split(key)
        return {"replay_class_noise": jax.random.gumbel(k1, (amt, jm.num_class)),
                "replay_slot_noise": jax.random.gumbel(k2, (amt, jm.capacity))}
    return {"replay_idx": _randint(key, (amt,), max(min(n_seen, jm.capacity), 1))}


def insert_draws(jm, key, n_seen, weight):
    """The JAX ``reservoir_add`` / ``balanced_add`` loop's draws from its
    key: a ``randint(0, n_i + 1)`` slot or a ``(cap,)`` Gumbel row an item."""
    slots, noise = [], []
    for w in np.asarray(weight):
        key, k1 = jax.random.split(key)
        slots.append(_randint(k1, (), n_seen + 1))
        noise.append(jax.random.gumbel(k1, (jm.capacity,)))
        n_seen += int(w > 0)
    if getattr(jm, "buffer_add", "reservoir") == "balanced":
        return {"evict_noise": jnp.stack(noise)}
    return {"slots": jnp.stack(slots)}


def step_draws(jm, key, task, n_seen, weight, old_valid=None):
    """(the next step's key, the port's draw dict) of one JAX ``train_step``
    from ``key`` (its ``state.rng``): ``split(key, 3)`` gives the next key
    (split again by the buffer's insertion) and the loss's key."""
    rng, _, loss_rng = jax.random.split(key, 3)
    name = type(jm).__name__
    # the buffer methods' post_update splits once more; PRAKA's does not
    next_key, sub = jax.random.split(rng) if name != "PRAKA" else (rng, None)
    b = len(weight)
    d = {}
    if name == "ERACE":
        d.update(_replay_draws(jm, jax.random.split(loss_rng)[0], n_seen, jm.replay_amt))
    elif name == "ERAML":
        k1, _, _, k4, k5, _ = jax.random.split(loss_rng, 6)
        for keys, (pos, neg), n in ((jax.random.split(k1), ("pos_noise", "neg_noise"), jm.capacity),
                                     (jax.random.split(k4), ("min_pos_noise", "min_neg_noise"), b)):
            d[pos], d[neg] = (jax.random.gumbel(k, (b, n)) for k in keys)
        d.update(_replay_draws(jm, k5, n_seen, jm.replay_amt))
    elif name == "OCM":
        hi = max(jm.feat_dim - jm.proj_dim, 1)
        if task == 0:
            kb = jax.random.split(jax.random.split(loss_rng)[1])[1]
            d["slice"] = jnp.stack([_randint(kb, (), hi)] * 2)
        else:
            k1, _, _, k4, k5, _ = jax.random.split(loss_rng, 6)
            d["replay_idx"] = _replay_draws(jm, k1, n_seen, jm._buffer_batch())["replay_idx"]
            d["slice"] = jnp.stack([_randint(k4, (), hi), _randint(k5, (), hi)])
    else:  # PRAKA
        k1, k2, k3, k4 = jax.random.split(loss_rng, 4)
        g = jax.random.gumbel(k1, (b, jm.num_class))
        d["cls"] = jnp.argmax(jnp.log(jnp.asarray(old_valid)[None, :] + 1e-30) + g, axis=1)
        d["lam"] = jax.random.beta(k2, 0.5, 0.5, (b, 1))
        d["row"] = _randint(k3, (b,), 4 * b)
        d["sign"] = jax.random.bernoulli(k4, 0.5, (b, 1))
    if name != "PRAKA":
        d.update(insert_draws(jm, sub, n_seen, weight))
    out = {}
    for k, v in d.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
    return next_key, out


def port_draw_args(state, batch):
    """What :func:`step_draws` reads from the port's state and batch."""
    mv = state.mvars
    n_seen = int(mv["buffer"]["n_seen"]) if "buffer" in mv else 0
    old_valid = (mv["proto_valid"] * state.prev_mask).numpy() if "protos" in mv else None
    return n_seen, batch["weight"].numpy(), old_valid


def feed_jax_draws(pm, jm, key):
    """Patch the port's ``draw`` to hand out the JAX run's draws from
    ``key`` on, one step a call."""
    box = [key]

    def draw(state, batch):
        n_seen, weight, old_valid = port_draw_args(state, batch)
        box[0], d = step_draws(jm, box[0], state.task, n_seen, weight, old_valid)
        return d

    pm.draw = draw


# ------------------------------------------------------------ the states


def methods(case):
    ov = config(case)
    jm = JAX_METHODS.get(ov["classifier"]["name"])(JaxConfig(overrides=copy.deepcopy(ov))
                                                   .get_config_dict())
    pm = METHODS.get(ov["classifier"]["name"])(Config(overrides=ov).get_config_dict(), "cpu")
    if case == "OCM":
        jm._simclr_aug, pm.simclr_aug = jax_simclr, port_simclr
    js = jax.jit(lambda key: jm.init_state(key, (8, 8, 3)))(jax.random.PRNGKey(0))
    if "buffer" in js.mvars:  # a buffer past its capacity, of both tasks' classes
        rng = np.random.RandomState(5)
        labels = rng.randint(0, 8, 24).astype(np.int32)
        buf = jer.reservoir_add(
            js.mvars["buffer"], jnp.asarray(rng.randint(0, 256, (24, 8, 8, 3)).astype(np.uint8)),
            jnp.asarray(labels), jnp.asarray(labels // 4), jnp.ones(24), jax.random.PRNGKey(9))
        js = js.replace(mvars={**js.mvars, "buffer": buf})
    js = jm.before_task(js, 0, None)
    ps = resnet_state_from_flax(pm, _numpy(js.params), _numpy(js.mvars))
    return jm, js, pm, ps


def batch(seed, lo=0, hi=4, b=8):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, 8, 8, 3)).astype(np.uint8)
    labels = rng.randint(lo, hi, b).astype(np.int32)
    weight = np.ones(b, np.float32)
    weight[-1] = 0.0  # a padding row weighs 0
    jb = {"image": jnp.asarray(images), "label": jnp.asarray(labels), "weight": jnp.asarray(weight)}
    pb = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels.astype(np.int64)),
          "weight": torch.from_numpy(weight)}
    return jb, pb


def task_data(seed, lo, hi, per_class=3):
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(lo, hi), per_class).astype(np.int32)
    images = rng.randint(0, 256, (len(labels), 8, 8, 3)).astype(np.uint8)
    return JaxTaskData(images, labels, lo, hi), TaskData(images, labels, lo, hi)


def _stats(js):
    return _numpy(js.mvars["model_state"]["batch_stats"])


def assert_state(js, ps, atol=GRAD_TOL):
    """Every parameter and running statistic of the port's state against the
    JAX state's, and the buffer bitwise."""
    ref = copy.deepcopy(ps.params)
    load_backbone_params(ref, _numpy(js.params), _stats(js))
    for (k, got), (_, want) in zip(ps.params.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=atol,
                                   rtol=0, err_msg=f"param {k}")
    for (k, got), (_, want) in zip(ps.params.named_buffers(), ref.named_buffers()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=1e-5,
                                   err_msg=f"stat {k}")
    if "buffer" in ps.mvars:
        jbuf = _numpy(js.mvars["buffer"])
        for k, v in ps.mvars["buffer"].items():
            np.testing.assert_array_equal(v.numpy(), jbuf[k], err_msg=f"buffer {k}")


def jitted(jm, name, fn):
    """``jax.jit(fn)``, compiled once a method and task branch (OCM traces
    its task-0 and incremental losses apart)."""
    cache = jm.__dict__.setdefault("_jit_cache_for_tests", {})
    key = (name, getattr(jm, "_cur_task", 0) > 0)
    if key not in cache:
        cache[key] = jax.jit(fn)
    return cache[key]


def jax_train_step(jm, js, jb, lr):
    return jitted(jm, "step", lambda s, b, lr: jm.train_step(s, b, lr))(js, jb, lr)


def loss_and_grads(jm, js, pm, ps, jb, pb):
    """Both losses (the JAX one from ``train_step``'s loss key), and the
    port's gradients beside the JAX ones by the port's parameter names; the
    port's running statistics are put back."""
    loss_rng = jax.random.split(js.rng, 3)[2]
    jb = dict(jb, x=jm.augment(None, jb["image"], train=False))
    (jl, _), jg = jitted(jm, "grad", jax.value_and_grad(jm.loss, has_aux=True))(
        js.params, js, jb, loss_rng)
    pb = dict(pb, x=pm.augment(None, pb["image"], train=False))
    ps.params.zero_grad(set_to_none=True)
    stats = {k: v.clone() for k, v in ps.params.named_buffers()}
    pl, _ = pm.loss(ps, pb)
    pl.backward()
    for k, v in ps.params.named_buffers():
        v.copy_(stats[k])
    ref = named_like(ps.params, _numpy(jg), _stats(js))
    got = {k: p.grad for k, p in ps.params.named_parameters() if p.grad is not None}
    return float(jl), float(pl.detach()), got, ref


def to_task1(jm, js, pm, ps):
    """Both sides through the boundary (after_task 0, start_task 1,
    before_task 1, reset_optimizer 1), the port then resynced to the JAX
    state."""
    jtd0, ptd0 = task_data(40, 0, 4)
    jtd1, _ = task_data(41, 4, 8)
    js = jm.start_task(jm.after_task(js, 0, jtd0), 1, 4, 8)
    js = jm.reset_optimizer(jm.before_task(js, 1, jtd1), 1)
    ps = pm.start_task(pm.after_task(ps, 0, ptd0), 1, 4, 8)
    load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))
    return js, pm.reset_optimizer(ps, 1)


# ----------------------------------------------------------------- tests


def test_rotation_expand_and_nt_xent_match_jax():
    rng = np.random.RandomState(0)
    x = rng.rand(3, 6, 6, 3).astype(np.float32)
    y = rng.randint(0, 5, 3).astype(np.int32)
    jx, jy = jocm.rotation_expand(jnp.asarray(x), jnp.asarray(y))
    px, py = ocm.rotation_expand(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    assert px.shape == (48, 6, 6, 3) and int(py.max()) >= 15000
    labels = rng.randint(0, 3, 8).astype(np.int32)  # repeated classes: several positives a row
    sim = rng.randn(16, 16).astype(np.float32)
    for mode in ("n", "uni"):
        want = float(jocm.nt_xent(jnp.asarray(sim), jnp.asarray(labels), 0.07, mode))
        got = float(ocm.nt_xent(torch.from_numpy(sim), torch.from_numpy(labels), 0.07, mode))
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (mode, got, want)
    labels16 = rng.randint(0, 4, 16).astype(np.int32)
    want = float(jocm.nt_xent_pre(jnp.asarray(sim), jnp.asarray(labels16), 0.07))
    got = float(ocm.nt_xent_pre(torch.from_numpy(sim), torch.from_numpy(labels16), 0.07))
    assert abs(got - want) <= TOL * max(1.0, abs(want))


def _slab(seed, n_seen, cap=8):
    rng = np.random.RandomState(seed)
    buf = {"bx": rng.randint(0, 256, (cap, 4, 4, 3)).astype(np.uint8),
           "by": rng.randint(0, 3, cap).astype(np.int32), "bt": np.zeros(cap, np.int32),
           "n_seen": np.int32(n_seen)}
    items = (rng.randint(0, 256, (10, 4, 4, 3)).astype(np.uint8),
             rng.randint(0, 5, 10).astype(np.int32), np.ones(10, np.int32))
    return buf, items


def _port_buf(buf):
    return {k: torch.from_numpy(np.array(v, dtype=np.uint8 if k == "bx" else np.int64))
            for k, v in buf.items()}


@pytest.mark.parametrize("strategy", ["reservoir", "balanced"])
@pytest.mark.parametrize("n_seen", [3, 12])
def test_buffer_add_matches_jax(strategy, n_seen):
    """From a part-filled slab (3 of 8) and a full one (12 seen): the slabs
    and ``n_seen`` equal bitwise, with item 6 a padded one. The reservoir
    case past capacity has two items drawn onto one slot."""
    buf, (images, labels, tasks) = _slab(n_seen, n_seen)
    weight = np.ones(10, np.float32)
    weight[6] = 0.0
    key = jax.random.PRNGKey(2)
    jm = types.SimpleNamespace(capacity=8, buffer_add=strategy)
    draws = insert_draws(jm, key, n_seen, weight)
    args = [jnp.asarray(a) for a in (images, labels, tasks, weight)]
    pargs = [torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)
             for a in (images, labels, tasks, weight)]
    pbuf = _port_buf(buf)
    if strategy == "balanced":
        jout = jer.balanced_add(dict(buf), *args, key, num_class=5)
        er.balanced_add(pbuf, *pargs, torch.from_numpy(np.array(draws["evict_noise"])), 5)
    else:
        jout = jer.reservoir_add(dict(buf), *args, key)
        slots = np.asarray(draws["slots"])
        er.reservoir_add(pbuf, *pargs, torch.from_numpy(slots.astype(np.int64)))
        if n_seen > 8:  # the draws put two weight-1 items on one slot
            n_i = n_seen + np.cumsum(weight > 0) - (weight > 0)
            hits = [int(s) for s, w, n in zip(slots, weight, n_i) if w > 0 and s < 8]
            assert len(hits) > len(set(hits))
    jout = _numpy(jout)
    assert int(pbuf["n_seen"]) == int(jout["n_seen"]) == n_seen + 9
    for k, v in pbuf.items():
        np.testing.assert_array_equal(v.numpy(), jout[k], err_msg=k)


def test_reservoir_duplicate_slots_keep_the_last_item():
    """Given slots by hand: items 1, 4 and 7 all go to slot 2 of a full slab
    and item 4 is padding, so item 7's row stays; a sequential loop over the
    batch agrees."""
    buf, (images, labels, tasks) = _slab(1, 20)
    weight = np.ones(10, np.float32)
    weight[4] = 0.0
    slots = np.array([30, 2, 25, 5, 2, 40, 6, 2, 33, 28])
    pbuf = _port_buf(buf)
    er.reservoir_add(pbuf, torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64)),
                     torch.from_numpy(tasks.astype(np.int64)), torch.from_numpy(weight),
                     torch.from_numpy(slots))
    ref = {k: np.array(v) for k, v in buf.items()}
    n = 20
    for i in range(10):  # the JAX package's loop, by hand
        if weight[i] > 0:
            if slots[i] < 8:
                ref["bx"][slots[i]], ref["by"][slots[i]] = images[i], labels[i]
            n += 1
    assert n == int(pbuf["n_seen"]) == 29
    np.testing.assert_array_equal(pbuf["bx"].numpy(), ref["bx"])
    np.testing.assert_array_equal(pbuf["by"].numpy(), ref["by"])
    np.testing.assert_array_equal(pbuf["bx"][2].numpy(), images[7])


@pytest.mark.parametrize("case", ["ERACE", "ERAML", "OCM", "PRAKA"])
def test_one_step_at_task0_and_two_at_task1(case):
    jm, js, pm, ps = methods(case)
    for step, task in enumerate((0, 1, 1)):
        if step == 1:
            js, ps = to_task1(jm, js, pm, ps)
        else:  # each step from the JAX state: the last step's drift was held by assert_state
            load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))
        jb, pb = batch(step, *((0, 4) if task == 0 else (0, 8)))
        _, d = step_draws(jm, js.rng, task, *port_draw_args(ps, pb))
        pm.draw = lambda state, b, d=d: d
        jl, pl, got, ref = loss_and_grads(jm, js, pm, ps, jb, pb)
        assert abs(pl - jl) <= TOL * max(1.0, abs(jl)), (step, pl, jl)
        assert got, step
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=GRAD_TOL, rtol=0,
                                       err_msg=f"step {step} grad {k}")
        js, jmet = jax_train_step(jm, js, jb, 0.05)
        ps, pmet = pm.train_step(ps, pb, 0.05)
        assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= TOL * max(1.0, abs(jl))
        assert float(pmet["acc"]) == float(jmet["acc"])
        assert_state(js, ps)


@pytest.mark.parametrize("case", ["ERACE", "OCM", "PRAKA"])
def test_after_task(case):
    jm, js, pm, ps = methods(case)
    if case != "ERACE":  # the teachers differ from the init
        js, _ = jax_train_step(jm, js, batch(20)[0], 0.05)
        load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))
    jtd, ptd = task_data(30, 0, 4, per_class=5)  # 20 images: a padded third batch
    js, ps = jm.after_task(js, 0, jtd), pm.after_task(ps, 0, ptd)
    mv, jmv = ps.mvars, _numpy(js.mvars)
    if case == "ERACE":
        assert mv["seen_so_far"] == int(jmv["seen_so_far"]) == 4
        return
    teacher = mv["teacher"]
    assert not any(p.requires_grad for p in teacher.parameters())
    for (k, t), (_, p) in zip(teacher.state_dict().items(), ps.params.state_dict().items()):
        assert torch.equal(t, p), k
    ref = copy.deepcopy(teacher)
    load_backbone_params(ref, jmv["teacher"], jmv["teacher_state"]["batch_stats"])
    for (k, t), (_, r) in zip(teacher.state_dict().items(), ref.state_dict().items()):
        np.testing.assert_allclose(t.numpy(), r.numpy(), atol=1e-6, rtol=0, err_msg=k)
    if case == "PRAKA":
        np.testing.assert_array_equal(mv["proto_valid"].numpy(), jmv["proto_valid"])
        assert mv["proto_valid"].tolist() == [1.0] * 4 + [0.0] * 4
        np.testing.assert_allclose(mv["protos"].numpy(), jmv["protos"], atol=TOL, rtol=TOL)


def test_methods_resolve_with_their_shipped_configs():
    """The shipped configs build the four methods on their backbones and
    buffers; ERACE and ERAML keep their slabs, OCM its replay batch and
    PRAKA its two heads, and PRAKA turns the per-epoch validation off."""
    import os

    from libcontinual_tpu_torch.core.buffer import build_buffer
    from libcontinual_tpu_torch.registry import BACKBONES

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = {"erace": ("ERACE", "resnet18_AML", "ERBuffer", 160),
            "eraml": ("ERAML", "resnet18_AML", "ERBuffer", 160),
            "ocm": ("OCM", "resnet18", "OnlineBuffer", 512),
            "praka": ("PRAKA", "resnet18", "LinearBuffer", 512),
            "PRAKA": ("PRAKA", "resnet18_cbam", "LinearBuffer", 512)}
    for name, (method, backbone, buffer, feat) in want.items():
        cfg = Config(os.path.join(repo, "configs", f"{name}.yaml")).get_config_dict()
        assert cfg["backbone"]["name"] == backbone and BACKBONES.get(backbone)
        assert cfg["buffer"]["name"] == buffer
        build_buffer(cfg, "cpu")
        m = METHODS.get(cfg["classifier"]["name"])(cfg, "cpu")
        assert type(m).__name__ == method == JAX_METHODS.get(method).__name__
        assert m.feat_dim == feat and m.device.type == "cpu" and not m.concat_buffer
        assert m.validate_enabled == (method != "PRAKA")
        if method.startswith("ER"):
            assert (m.capacity, m.replay_amt, m.task_free) == (1000, 10, True)
        if method == "OCM":
            assert (m.capacity, m.proj_dim, m.buffer_batch(1)) == (2000, 128, 64)
