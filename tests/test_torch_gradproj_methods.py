"""The port's gradient-projection methods (GPM, TRGP and API on AlexNet,
DMNSP on ``vit_tiny_test`` with 8-wide adapters) against the JAX package's,
in float32 (AlexNet at its only geometry, 32x32), from the same weights (the
JAX state converted, with the method's host-side state).

The dropout masks are the JAX run's: recorded from ``jax.random.bernoulli``
inside the jitted JAX loss (flax's ``Dropout`` in AlexNet, the adapter's own
draw in the ViT) and handed to the port's ``draw`` seam.

Held, per method: one step at task 0 and one at task 1 (the loss, every
gradient after ``transform_grads`` and the update mask, then the parameters
after the SGD step); each boundary hook (``after_task`` 0, then
``before_task`` 1) from the same state: GPM's and TRGP's bases as projectors
``U U^T`` with their ranks, TRGP's task spaces, trust-region blocks and
selected tasks, API's project types, projections, retain ratios, expansion
counts, its mixes up to the columns' signs and the protocol's trained
parameters, DMNSP's ``P``, basis counts and ``lam``. Singular vectors'
signs are arbitrary, so no basis is compared column by column. And
``dual_gpm_update``, ``nsp_lambda`` and ``nsp_extend_basis`` on random
matrices. Each step and hook starts from the JAX state (the port resynced
after its result was held)."""

from __future__ import annotations

import copy

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
from libcontinual_tpu.methods import dmnsp as jdmnsp  # noqa: E402
from libcontinual_tpu.methods.inflora import dual_gpm_update as jax_dual_gpm  # noqa: E402
from libcontinual_tpu.registry import METHODS as JAX_METHODS  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import (  # noqa: E402
    HOST_ATTRS, gradproj_state_from_flax, load_gradproj_params, load_gradproj_state)
from libcontinual_tpu_torch.data.continual import TaskData  # noqa: E402
from libcontinual_tpu_torch.methods import dmnsp  # noqa: E402
from libcontinual_tpu_torch.methods.dualgpm import dual_gpm_update  # noqa: E402
from libcontinual_tpu_torch.registry import METHODS  # noqa: E402
from test_torch_alexnet import assert_close_to_scale, nchw_keep, recorded_bernoulli  # noqa: E402

#: losses, f32 on the CPU (relative where above 1)
TOL = 1e-5
#: gradients and parameters after one SGD step, relative to the largest
#: entry of the JAX tensor
GRAD_TOL = 1e-4
#: projectors U U^T and P from float64 SVDs of activations that agree to f32
#: noise; DMNSP's are f32 SVDs and QRs (as in the JAX package)
PROJ_TOL = 1e-4
#: API's retain ratios (means of f32 norm ratios) and DMNSP's lambdas
RATIO_TOL = 1e-4

NORM = [{"Normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]}}]
BASE = {
    "dataset": "synthetic", "data_root": "", "image_size": 32, "task_num": 2,
    "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 8, "seed": 3, "dtype": "float32",
    "augment": False, "train_trfms": NORM, "test_trfms": NORM, "setting": "task-aware",
    "mesh": {"data": 1, "model": 1}, "lr_scheduler": {"name": "Constant"}, "warmup": 0,
    # plain SGD: Adam's normalised first update would turn float noise in
    # near-zero gradients (DMNSP's down weights while up is zero) into steps
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05}},
}
#: (backbone, backbone kwargs, classifier kwargs) of each method
CASES = {
    "GPM": ("AlexNet_TRGP", {}, {"feat_dim": 2048}),
    "TRGP": ("AlexNet_TRGP", {}, {"feat_dim": 2048, "label_smoothing": 0.1}),
    "API": ("AlexNet_API", {}, {"feat_dim": 2048, "stage1_epochs": 1}),
    "DMNSP": ("vit_tiny_test", {"adapter_dim": 8},
              {"feat_dim": 64, "embd_dim": 64, "label_smoothing": 0.1, "lamda_scale": 30.0}),
}
LR = 0.05


def config(name, **over):
    backbone, bk, ck = CASES[name]
    ov = copy.deepcopy(BASE)
    ov["backbone"] = {"name": backbone, "kwargs": dict(bk)}
    ov["classifier"] = {"name": name, "kwargs": {
        "num_class": 8, "init_cls_num": 4, "inc_cls_num": 4, "task_num": 2, **ck}}
    ov.update(copy.deepcopy(over))
    return ov


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def host_state(jm) -> dict:
    """The JAX method's host-side state, as numpy."""
    return {k: copy.deepcopy(getattr(jm, k)) for k in HOST_ATTRS if hasattr(jm, k)}


class JitEvalApplies:
    """A JAX backbone whose evaluation-mode ``apply`` calls (the captures and
    passes of the task-boundary hooks, which the JAX package runs eagerly)
    run as jitted programs, one a set of static arguments; training calls
    (dropout keys in ``rngs``) go to the module as they are. Other
    attributes are the module's."""

    def __init__(self, module):
        self._module, self._cache = module, {}

    def __getattr__(self, name):
        return getattr(self._module, name)

    def apply(self, variables, *args, **kwargs):
        if kwargs.get("train", True) or kwargs.get("rngs"):
            return self._module.apply(variables, *args, **kwargs)
        static = tuple(sorted((k, v) for k, v in kwargs.items()
                              if isinstance(v, (bool, str)) or v is None))
        dynamic = {k: v for k, v in kwargs.items() if k not in dict(static)}
        if static not in self._cache:
            module, fixed = self._module, dict(static)
            self._cache[static] = jax.jit(
                lambda v, a, d: module.apply(v, *a, **fixed, **d))
        return self._cache[static](variables, args, dynamic)


def jitted(jm, name, fn):
    """``jax.jit(fn)``, compiled once a method."""
    cache = jm.__dict__.setdefault("_jit_cache_for_tests", {})
    if name not in cache:
        cache[name] = jax.jit(fn)
    return cache[name]


def methods(name, **over):
    """(JAX method, JAX state, port method, port state), the port's
    converted from the JAX one."""
    ov = config(name, **over)
    jm = JAX_METHODS.get(name)(JaxConfig(overrides=copy.deepcopy(ov)).get_config_dict())
    jm.backbone = JitEvalApplies(jm.backbone)
    pm = METHODS.get(name)(Config(overrides=copy.deepcopy(ov)).get_config_dict(), "cpu")
    js = jax.jit(lambda key: jm.init_state(key, (32, 32, 3)))(jax.random.PRNGKey(0))
    js = jm.before_task(js, 0, None)
    ps = pm.before_task(resync(jm, js, pm, None), 0, None)
    return jm, js, pm, ps


def resync(jm, js, pm, ps):
    """The port's state set to the JAX state (a new one where ``ps`` is None)."""
    params, mvars = _numpy(js.params), _numpy(js.mvars)
    if ps is None:
        return gradproj_state_from_flax(pm, params, mvars, host_state(jm))
    load_gradproj_state(pm, ps, params, mvars, host_state(jm))
    return ps


def named(ps, tree) -> dict:
    """A JAX tree shaped like ``state.params`` (parameters or gradients), by
    the port's parameter names."""
    ref = copy.deepcopy(ps.params)
    load_gradproj_params(ref, _numpy(tree))
    return {k: p.detach() for k, p in ref.named_parameters()}


def batch(seed, lo, hi, b=8):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
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
    images = rng.randint(0, 256, (len(labels), 32, 32, 3)).astype(np.uint8)
    return JaxTaskData(images, labels, lo, hi), TaskData(images, labels, lo, hi)


def port_draws(name, masks) -> dict:
    """The JAX run's dropout masks as the port's draw."""
    if name == "DMNSP":
        return {"adapter_keep": [torch.from_numpy(np.array(m)) for m in masks]}
    return {"keep": nchw_keep(masks)}


def jax_grads(jm, js, jb):
    """The JAX loss (from ``train_step``'s loss key), the gradients after
    ``transform_grads`` and the update mask, and the dropout masks drawn."""
    def fn(state, b):
        loss_rng = jax.random.split(state.rng, 3)[2]
        b = dict(b, x=jm.augment(None, b["image"], train=False))
        drawn = []
        with recorded_bernoulli(drawn):
            (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(state.params, state, b,
                                                                     loss_rng)
        g = jm.transform_grads(g, state)
        mask = jm.trainable_mask(state)
        if mask is not None:
            g = jax.tree_util.tree_map(lambda a, m: a * m, g, mask)
        return loss, g, drawn

    return jitted(jm, "grads", fn)(js, jb)


def port_grads(pm, ps, pb, draws):
    """The port's loss and gradients after ``transform_grads`` and the
    update mask, by parameter name."""
    pm.draw = lambda state, b: draws
    pb = dict(pb, x=pm.augment(None, pb["image"], train=False))
    ps.params.zero_grad(set_to_none=True)
    loss, _ = pm.loss(ps, pb)
    loss.backward()
    pm.transform_grads(ps)
    for p, m in (pm.trainable_mask(ps) or {}).items():
        p.grad.mul_(m)
    return float(loss.detach()), {k: p.grad.clone() for k, p in ps.params.named_parameters()
                         if p.grad is not None}


def step_and_check(name, jm, js, pm, ps, seed, task):
    """One step on both sides from the same state; returns the new states."""
    lo, hi = (0, 4) if task == 0 else (4, 8)
    jb, pb = batch(seed, lo, hi)
    jl, jg, masks = jax_grads(jm, js, jb)
    assert len(masks) == (4 if name == "DMNSP" else 5)
    draws = port_draws(name, masks)
    pl, got = port_grads(pm, ps, pb, draws)
    assert abs(pl - float(jl)) <= TOL * max(1.0, abs(float(jl))), (task, pl, float(jl))
    ref = named(ps, jg)
    assert set(got) == set(ref)
    for k, g in got.items():
        assert_close_to_scale(g.numpy(), ref[k].numpy(), err_msg=f"task {task} grad {k}")
    frozen0 = ({k: v.clone() for k, v in ps.mvars["frozen"].state_dict().items()
                if ".adaptmlp." not in k} if name == "DMNSP" else None)
    js, _ = jitted(jm, "step", lambda s, b: jm.train_step(s, b, LR))(js, jb)
    ps, pmet = pm.train_step(ps, pb, LR)
    assert abs(float(pmet["loss"]) - float(jl)) <= TOL * max(1.0, abs(float(jl)))
    want = named(ps, js.params)
    for k, p in ps.params.named_parameters():
        assert_close_to_scale(p.detach().numpy(), want[k].numpy(), err_msg=f"task {task} {k}")
    if frozen0 is not None:  # the trunk keeps its bits
        now = ps.mvars["frozen"].state_dict()
        assert all(torch.equal(v, now[k]) for k, v in frozen0.items())
    return js, ps


def proj_of(u) -> np.ndarray:
    u = np.asarray(u, np.float64)
    return u @ u.T


def assert_bases(port_list, jax_list, what):
    """Each layer's basis: the rank exactly, the projector within PROJ_TOL."""
    assert len(port_list) == len(jax_list)
    for li, (u, v) in enumerate(zip(port_list, jax_list)):
        assert u.shape == np.asarray(v).shape, (what, li, u.shape, np.asarray(v).shape)
        np.testing.assert_allclose(proj_of(u.numpy()), proj_of(v), atol=PROJ_TOL,
                                   err_msg=f"{what} layer {li}")


def boundary(name, jm, js, pm, ps):
    """after_task 0, start_task 1, before_task 1 and reset_optimizer 1 on
    both sides from the same state, with their outputs held; returns the
    new states (the port's resynced)."""
    jtd0, ptd0 = task_data(40, 0, 4)
    jtd1, ptd1 = task_data(41, 4, 8)
    ps = resync(jm, js, pm, ps)
    js, ps = jm.after_task(js, 0, jtd0), pm.after_task(ps, 0, ptd0)
    jmv = _numpy(js.mvars)
    if name in ("GPM", "TRGP", "API"):
        assert_bases(pm._feature_list, jm._feature_list, "feature_list")
        assert any(u.shape[1] > 0 for u in pm._feature_list)
        for li, (p, q) in enumerate(zip(ps.mvars["proj"], jmv["proj"])):
            np.testing.assert_allclose(p.numpy(), q, atol=PROJ_TOL, err_msg=f"proj {li}")
    if name == "TRGP":
        assert_bases(pm._task_spaces[0], jm._task_spaces[0], "task space 0")
    if name == "API":
        assert pm._project_type == jm._project_type
        np.testing.assert_array_equal(ps.mvars["proj_sign"].numpy(), jmv["proj_sign"])
    if name == "DMNSP":
        assert ps.mvars["basis_n"] == [int(n) for n in jmv["basis_n"]] == [63] * 4
        np.testing.assert_allclose(ps.mvars["P"].numpy(), jmv["P"], atol=PROJ_TOL)

    ps = resync(jm, js, pm, ps)
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    js = jm.before_task(js, 1, jtd1)
    ps = pm.before_task(ps, 1, ptd1)
    jmv = _numpy(js.mvars)
    if name == "TRGP":
        for li in range(5):
            jsel = [t for t in range(2) if np.abs(jmv["tr_space"][li][1][t]).sum() > 0]
            assert pm.selected[li] == jsel[:len(pm.selected[li])] and len(pm.selected[li]) == len(jsel)
            for j in range(2):
                np.testing.assert_allclose(proj_of(ps.mvars["tr_space"][li][1][j].numpy()),
                                           proj_of(jmv["tr_space"][li][1][j]), atol=PROJ_TOL)
        assert any(pm.selected), "no layer picked a trust region"
    if name == "API":
        np.testing.assert_allclose(pm.per_layer_retain, jm.per_layer_retain, atol=RATIO_TOL)
        jax_counts = np.asarray(jm._ws_counts)
        np.testing.assert_array_equal(pm._ws_counts, jax_counts)
        assert jax_counts.sum() > 0, "no layer expanded"
        for li in range(5):
            got = getattr(ps.params["backbone"], f"ws{li}").detach().numpy()
            want = _numpy(js.params)["backbone"][f"ws{li}"]
            sign = np.sign(np.sum(got * want, axis=1, keepdims=True))  # per (slot, column)
            np.testing.assert_allclose(got * np.where(sign == 0, 1, sign), want, atol=PROJ_TOL,
                                       err_msg=f"ws{li}")
        for key in ("old_rows", "ws_mask"):
            for a, b in zip(ps.mvars[key], jmv[key]):
                np.testing.assert_array_equal(a.numpy(), b)
        want = named(ps, js.params)  # the protocol trained the kernels and the head
        for k, p in ps.params.named_parameters():
            if not k.startswith("backbone.ws"):
                assert_close_to_scale(p.detach().numpy(), want[k].numpy(), err_msg=k)
    if name == "DMNSP":
        assert ps.mvars["proj_on"] and bool(jmv["proj_on"] > 0)
        np.testing.assert_allclose(ps.mvars["lam"].numpy(), jmv["lam"], rtol=RATIO_TOL)
        assert float(ps.mvars["lam"].max()) != 1.0
    js = jm.reset_optimizer(js, 1)
    ps = pm.reset_optimizer(resync(jm, js, pm, ps), 1)
    return js, ps


@pytest.mark.parametrize("name", list(CASES))
def test_one_step_at_task0_boundary_and_task1(name):
    jm, js, pm, ps = methods(name)
    js, ps = step_and_check(name, jm, js, pm, ps, seed=0, task=0)
    js, ps = boundary(name, jm, js, pm, resync(jm, js, pm, ps))
    if name in ("GPM", "TRGP"):  # BN frozen from task 1 on
        assert pm.trainable_mask(ps) and not ps.mvars["bn_trainable"]
    step_and_check(name, jm, js, pm, ps, seed=1, task=1)


# ------------------------------------------------------- the math alone


def _low_rank(rng, d, n, rank, noise=1e-3):
    return (rng.randn(d, rank) @ rng.randn(rank, n) + noise * rng.randn(d, n))


def test_dual_gpm_update_matches_jax():
    """Three layers over three calls: a low-rank layer (remove, growing), a
    full-rank one (retain from the start, shrinking) and one that grows past
    half its width (remove turned retain)."""
    rng = np.random.RandomState(0)
    dims = [(40, 60, 2), (10, 40, 10), (16, 50, 6)]
    jf, jt, tf, tt = [], [], [], []
    for call, threshold in enumerate((0.95, 0.97, 0.99)):
        mats = [_low_rank(rng, d, n, r + 2 * call) for d, n, r in dims]
        jax_dual_gpm(jf, jt, [m.copy() for m in mats], threshold)
        dual_gpm_update(tf, tt, [torch.from_numpy(m) for m in mats], threshold)
        assert tt == jt, (call, tt, jt)
        assert_bases(tf, jf, f"call {call}")
    assert tt == ["remove", "retain", "retain"]


def _orthonormal(rng, d, n):
    q, _ = np.linalg.qr(rng.randn(d, d))
    return q[:, :n].astype(np.float32)


def test_nsp_lambda_and_extend_basis_match_jax():
    """Random covariances (f32, as the capture gives them) and a basis with
    counts 0, 5 and 12 of 16: lambdas, the extended counts and P."""
    rng = np.random.RandomState(1)
    d, depth = 16, 3
    basis = np.zeros((depth, d, d), np.float32)
    counts = np.array([0, 5, 12], np.int32)
    for i, n in enumerate(counts):
        basis[i][:, :n] = _orthonormal(rng, d, n)
    covs = []
    for _ in range(depth):
        a = rng.randn(40, d).astype(np.float32)
        covs.append((a.T @ a).astype(np.float32))
    want = jdmnsp.nsp_lambda(basis, counts, covs, depth, 30.0)
    got = dmnsp.nsp_lambda(torch.from_numpy(basis), counts.tolist(),
                           [torch.from_numpy(c) for c in covs], 30.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RATIO_TOL)
    assert want[0] == 1.0 and want[1] != 1.0
    jb, jn, jp = jdmnsp.nsp_extend_basis(basis, counts, covs, depth)
    tb, tn, tp = dmnsp.nsp_extend_basis(torch.from_numpy(basis), counts.tolist(),
                                        [torch.from_numpy(c) for c in covs])
    assert tn == [int(n) for n in jn] == [15, 16, 16]
    np.testing.assert_allclose(tp.numpy(), jp, atol=PROJ_TOL)
    for i, n in enumerate(tn):
        np.testing.assert_allclose(proj_of(tb[i][:, :n].numpy()), proj_of(jb[i][:, :n]),
                                   atol=PROJ_TOL)


def test_smoothed_ce_matches_jax():
    """DMNSP's smoothing (``s / n_valid`` on each valid class) with a padded
    row, against the JAX function."""
    rng = np.random.RandomState(2)
    logits = rng.randn(6, 8).astype(np.float32)
    labels = rng.randint(4, 8, 6)
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)
    mask = (np.arange(8) >= 4).astype(np.float32)
    for w in (None, weight):
        want = float(jdmnsp.smoothed_ce(jnp.asarray(logits), jnp.asarray(labels),
                                        None if w is None else jnp.asarray(w), jnp.asarray(mask),
                                        0.1))
        got = float(dmnsp.smoothed_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if w is None else torch.from_numpy(w),
                                      torch.from_numpy(mask), 0.1))
        assert abs(got - want) <= TOL * max(1.0, abs(want))


def test_methods_resolve_with_their_shipped_configs():
    """The shipped configs build the four methods on their backbones: GPM
    and TRGP on AlexNet_TRGP, API on AlexNet_API (slab 9 x 5), DMNSP on the
    adapter ViT-B/16 (64-wide adapters, QuickGELU in dmnsp_vit), and TRGP on
    a CLIP backbone refuses, citing its ROADMAP item."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = {"gpm": ("GPM", "AlexNet_TRGP"), "trgp": ("TRGP", "AlexNet_TRGP"),
            "api_til": ("API", "AlexNet_API"), "dmnsp": ("DMNSP", "ViTZoo"),
            "dmnsp_vit": ("DMNSP", "ViTZoo")}
    for cfg_name, (method, backbone) in want.items():
        cfg = Config(os.path.join(repo, "configs", f"{cfg_name}.yaml")).get_config_dict()
        m = METHODS.get(cfg["classifier"]["name"])(cfg, "cpu")
        assert type(m).__name__ == method and cfg["backbone"]["name"] == backbone
        assert m.validate_enabled == (method != "TRGP")
        if method == "API":
            assert (m.slots, m.k_slot, m.in_flats[0]) == (9, 5, 48 * 16)
        if method == "DMNSP":  # what the factory reads (tests/test_torch_models.py)
            bk = cfg["backbone"]["kwargs"]
            assert bk["adapter_dim"] == 64 and bk["block_ln_eps"] == 1e-5
            assert bk.get("act_layer") == ("QuickGELU" if cfg_name == "dmnsp_vit" else None)
            assert m.embed_dim == 768 and m.lamda_scale == 30.0
    cfg = config("TRGP")
    cfg["backbone"] = {"name": "clip", "kwargs": {}}
    with pytest.raises(NotImplementedError, match="8b"):
        METHODS.get("TRGP")(Config(overrides=cfg).get_config_dict(), "cpu")


def test_task_boundary_svds_take_gesvd_on_the_card(monkeypatch):
    """The hooks' SVDs ask cuSOLVER for gesvd on a CUDA tensor (its default
    Jacobi driver falls back after seconds on rank-deficient residuals) and
    for no driver on the CPU, where the results are torch.linalg's own."""
    from libcontinual_tpu_torch.methods import common

    a = torch.from_numpy(np.random.RandomState(0).randn(6, 9))
    u, s, vh = common.svd(a, full_matrices=False)
    want = torch.linalg.svd(a, full_matrices=False)
    assert torch.equal(s, want[1]) and torch.equal(u, want[0]) and torch.equal(vh, want[2])
    assert torch.equal(common.svdvals(a), torch.linalg.svdvals(a))
    drivers = []
    monkeypatch.setattr(torch.linalg, "svd", lambda x, full_matrices=True, driver=None:
                        drivers.append(driver))
    monkeypatch.setattr(torch.linalg, "svdvals", lambda x, driver=None: drivers.append(driver))
    card = type("CudaTensor", (), {"is_cuda": True})()
    common.svd(card), common.svdvals(card), common.svd(a), common.svdvals(a)
    assert drivers == ["gesvd", "gesvd", None, None]
