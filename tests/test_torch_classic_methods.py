"""The port's classic ResNet methods (EWC, LwF, WA, LUCIR, BiC, DER) against
the JAX package's on ``cifar_resnet20`` (DER: two ``tiny_cnn`` extractors)
at 8x8 in float32, from the same weights (the JAX state converted): the loss
and every gradient of one step at task 0 and two at task 1, and the
parameters and running statistics after each (SGD with momentum and weight decay); every
boundary hook from one common state (EWC's Fisher and the running
statistics its train-mode passes move, WA's aligned head, LUCIR's imprinted
rows and ``cur_lamda``, BiC's held-out split and stage 2, DER's warm start
and ``weight_align``); and the update masks: LUCIR's old head rows and DER's
old extractor bitwise unchanged by a step with weight decay.

The random uint8 batches at 8x8 keep every ReLU input of the network clear
of 0 by more than the two sides' float32 difference (about 1e-5 at the last
block): where one lies within it (task-0 batch seed 10; task-1 Fisher data
seed 31) the two sides' ReLU masks differ at that pixel and every gradient
below it moves by a few per cent, while the port agrees with its own
float64 run to 1e-7."""

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
from libcontinual_tpu.core.buffer import LinearSpiltBuffer as JaxSplitBuffer  # noqa: E402
from libcontinual_tpu.data.continual import TaskData as JaxTaskData  # noqa: E402
from libcontinual_tpu.registry import METHODS as JAX_METHODS  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import (  # noqa: E402
    load_backbone_params, load_method_state, named_like, resnet_state_from_flax)
from libcontinual_tpu_torch.core.buffer import LinearSpiltBuffer  # noqa: E402
from libcontinual_tpu_torch.data.continual import TaskData  # noqa: E402
from libcontinual_tpu_torch.registry import METHODS  # noqa: E402

#: float32 losses (the iCaRL file's)
TOL = 1e-5
#: gradients and one SGD step through the conv / BatchNorm layers
GRAD_TOL = 1e-4
#: the Fisher, a sum of squared gradients, relative to its entries: the JAX
#: package's EWC lockstep figure (``tests/test_trainer_lockstep_ewc.py``)
FISHER_RTOL, FISHER_ATOL = 5e-3, 1e-9

NAMES = ["EWC", "LWF", "WA", "LUCIR", "bic", "DER"]
NORM = [{"Normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]}}]
OVERRIDES = {
    "dataset": "synthetic", "data_root": "", "image_size": 8, "task_num": 2,
    "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 8, "seed": 3, "dtype": "float32",
    "augment": False, "train_trfms": NORM, "test_trfms": NORM, "stage2_epoch": 2,
    "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "cifar_resnet20", "kwargs": {}},
    "classifier": {"name": "EWC", "kwargs": {
        "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4, "task_num": 2}},
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9, "weight_decay": 5e-4}},
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _config(name, **kwargs):
    ov = copy.deepcopy(OVERRIDES)
    ov["classifier"]["name"] = name
    ov["classifier"]["kwargs"].update(kwargs)
    if name == "DER":
        ov["backbone"]["name"] = "tiny_cnn"
        ov["classifier"]["kwargs"]["feat_dim"] = 32
    return ov


def _methods(name, **kwargs):
    ov = _config(name, **kwargs)
    jm = JAX_METHODS.get(name)(JaxConfig(overrides=copy.deepcopy(ov)).get_config_dict())
    pm = METHODS.get(name)(Config(overrides=ov).get_config_dict(), "cpu")
    js = jm.init_state(jax.random.PRNGKey(0), (8, 8, 3))
    ps = resnet_state_from_flax(pm, _numpy(js.params), _numpy(js.mvars))
    # the trainer's task-0 hook (DER's active count, LUCIR's cur_lamda)
    return jm, jm.before_task(js, 0, None), pm, pm.before_task(ps, 0, None)


def _batch(seed, lo=0, hi=4):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (8, 8, 8, 3)).astype(np.uint8)
    labels = rng.randint(lo, hi, 8).astype(np.int32)
    weight = np.ones(8, np.float32)
    weight[-2:] = 0.0  # padding rows weigh 0
    jb = {"image": jnp.asarray(images), "label": jnp.asarray(labels), "weight": jnp.asarray(weight)}
    pb = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels.astype(np.int64)),
          "weight": torch.from_numpy(weight)}
    return jb, pb


def _task_data(seed, lo, hi, per_class=5):
    """The same task's images as a JAX and a port ``TaskData``."""
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.arange(lo, hi), per_class).astype(np.int32)
    images = rng.randint(0, 256, (len(labels), 8, 8, 3)).astype(np.uint8)
    return JaxTaskData(images, labels, lo, hi), TaskData(images, labels, lo, hi)


def _stats(js):
    return _numpy(js.mvars["model_state"]["batch_stats"])


def _assert_named(got: dict, ref: dict, atol, rtol=0.0, what=""):
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.detach().numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {k}")


def _assert_state(js, ps, atol=GRAD_TOL):
    """Every parameter and running statistic of the port's state against the
    JAX state's."""
    ref = copy.deepcopy(ps.params)
    load_backbone_params(ref, _numpy(js.params), _stats(js))
    _assert_named(dict(ps.params.named_parameters()), dict(ref.named_parameters()), atol,
                  what="param")
    for (k, got), (_, want) in zip(ps.params.named_buffers(), ref.named_buffers()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=1e-5,
                                   err_msg=f"stat {k}")


def _loss_and_grads(jm, js, pm, ps, jb, pb):
    """Both losses, and the port's gradients beside the JAX ones (by the
    port's parameter names); the port's running statistics are put back."""
    jb = dict(jb, x=jm.augment(None, jb["image"], train=False))
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, js, jb, None), has_aux=True)(js.params)
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


def _task1_labels(name):
    # EWC and LwF train on the current task's classes only (no replay)
    return (4, 8) if name in ("EWC", "LWF") else (0, 8)


def _to_task1(jm, js, pm, ps):
    """Both sides through the JAX boundary (after_task 0, start_task 1,
    before_task 1, reset_optimizer 1), the port then resynced to the JAX
    state."""
    jtd0, _ = _task_data(40, 0, 4)
    jtd1, _ = _task_data(41, 4, 8)
    js = jm.after_task(js, 0, jtd0)
    js = jm.start_task(js, 1, 4, 8)
    js = jm.before_task(js, 1, jtd1)
    js = jm.reset_optimizer(js, 1)
    ps = pm.start_task(ps, 1, 4, 8)
    load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))
    ps = pm.reset_optimizer(ps, 1)
    return js, ps


@pytest.mark.parametrize("name", NAMES)
def test_one_step_at_task0_and_two_at_task1(name):
    """The second task-1 step's student has moved from its teacher and from
    EWC's reference parameters, so the KD and penalty terms have gradients."""
    jm, js, pm, ps = _methods(name)
    for step, task in enumerate((0, 1, 1)):
        if step == 1:
            js, ps = _to_task1(jm, js, pm, ps)
        jb, pb = _batch(step, *((0, 4) if task == 0 else _task1_labels(name)))
        jl, pl, got, ref = _loss_and_grads(jm, js, pm, ps, jb, pb)
        assert abs(pl - jl) <= TOL, (step, pl, jl)
        assert got, step
        for k, g in got.items():
            np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=GRAD_TOL, rtol=0,
                                       err_msg=f"step {step} grad {k}")
        js, jmet = jm.train_step(js, jb, 0.05)
        ps, pmet = pm.train_step(ps, pb, 0.05)
        assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= TOL
        assert float(pmet["acc"]) == float(jmet["acc"])
        _assert_state(js, ps)


def _common(name, **kwargs):
    """A state after one task-0 step on the JAX side, held by both."""
    jm, js, pm, ps = _methods(name, **kwargs)
    jb, _ = _batch(20)
    js, _ = jm.train_step(js, jb, 0.05)
    load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))
    return jm, js, pm, ps


def test_ewc_fisher_moves_the_running_statistics():
    jm, js, pm, ps = _common("EWC")
    jtd0, ptd0 = _task_data(30, 0, 4, per_class=5)  # 20 images: a padded third batch
    before = {k: v.clone() for k, v in ps.params.named_buffers()}
    js, ps = jm.after_task(js, 0, jtd0), pm.after_task(ps, 0, ptd0)
    stats = _stats(js)
    for key in ("fisher", "ref_params"):
        ref = named_like(ps.params, _numpy(js.mvars[key]), stats)
        tol = dict(atol=FISHER_ATOL, rtol=FISHER_RTOL) if key == "fisher" else dict(atol=0)
        _assert_named(ps.mvars[key], ref, what=key, **tol)
    assert any(not torch.equal(before[k], v) for k, v in ps.params.named_buffers())
    _assert_state(js, ps, atol=1e-5)
    # task 1: the merge with alpha 1/2, the head rows of classes 4-7 new
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    jtd1, ptd1 = _task_data(32, 4, 8, per_class=4)
    js, ps = jm.after_task(js, 1, jtd1), pm.after_task(ps, 1, ptd1)
    ref = named_like(ps.params, _numpy(js.mvars["fisher"]), _stats(js))
    _assert_named(ps.mvars["fisher"], ref, atol=FISHER_ATOL, rtol=FISHER_RTOL, what="merged fisher")
    assert float(ps.mvars["fisher"]["head.dense.weight"][:4].abs().sum()) > 0


def test_wa_aligns_the_new_rows():
    jm, js, pm, ps = _common("WA")
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    before = ps.params["head"].dense.weight.detach().clone()
    js, ps = jm.after_task(js, 1, None), pm.after_task(ps, 1, None)
    w = ps.params["head"].dense.weight.detach()
    np.testing.assert_allclose(w.T.numpy(), np.asarray(js.params["head"]["Dense_0"]["kernel"]),
                               atol=1e-6, rtol=0)
    assert torch.equal(w[:4], before[:4]) and not torch.equal(w[4:], before[4:])
    norms = torch.linalg.vector_norm(w, dim=1)
    assert abs(float(norms[:4].mean() - norms[4:].mean())) < 1e-5
    teacher = ps.mvars["teacher"]["head"].dense.weight
    assert torch.equal(teacher, w) and not teacher.requires_grad


def test_lucir_imprints_the_new_rows():
    jm, js, pm, ps = _common("LUCIR")
    assert ps.mvars["cur_lamda"] == float(js.mvars["cur_lamda"]) == 5.0
    jtd1, ptd1 = _task_data(32, 4, 8, per_class=5)  # 5 images a class: one padded batch of 8
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    before = ps.params["head"].weight.detach().clone()
    js, ps = jm.before_task(js, 1, jtd1), pm.before_task(ps, 1, ptd1)
    w = ps.params["head"].weight.detach()
    np.testing.assert_allclose(w.T.numpy(), np.asarray(js.params["head"]["kernel"]),
                               atol=1e-6, rtol=0)
    assert torch.equal(w[:4], before[:4])
    assert abs(ps.mvars["cur_lamda"] - float(js.mvars["cur_lamda"])) < 1e-6
    np.testing.assert_array_equal(ps.mvars["head_col_mask"].numpy(),
                                  np.asarray(js.mvars["head_col_mask"]))


def _split_buffers():
    rng = np.random.RandomState(7)
    labels = np.repeat(np.arange(4), 3).astype(np.int32)
    images = rng.randint(0, 256, (len(labels), 8, 8, 3)).astype(np.uint8)
    bufs = []
    for cls in (JaxSplitBuffer, LinearSpiltBuffer):
        buf = cls(buffer_size=12, split_ratio=0.34)
        buf.images, buf.labels = images.copy(), labels.copy()
        bufs.append(buf)
    return bufs


def test_bic_held_out_split_and_stage2():
    jm, js, pm, ps = _common("bic")
    jtd1, ptd1 = _task_data(33, 4, 8, per_class=6)
    jbuf, pbuf = _split_buffers()
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    js, ps = jm.before_task(js, 1, jtd1), pm.before_task(ps, 1, ptd1)
    assert abs(ps.mvars["wd"] - float(js.mvars["wd"])) < 1e-9 and ps.mvars["wd"] == 2e-4
    jtrain, ptrain = jm.build_train_data(jtd1, jbuf, 1), pm.build_train_data(ptd1, pbuf, 1)
    for got, ref in ((ptrain, jtrain), (pm.stage2_data, jm._stage2_data)):
        np.testing.assert_array_equal(got.labels, ref.labels)
        np.testing.assert_array_equal(got.images, ref.images)
    assert len(ptrain) == 20 + 8 and len(pm.stage2_data) == 4 + 4
    # stage 2 from a state whose bias layers are not the identity
    js.mvars["alphas"] = js.mvars["alphas"].at[0].set(0.9)
    js.mvars["betas"] = js.mvars["betas"].at[0].set(0.2)
    load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))
    js, ps = jm.extra_phases(None, js, 1, jtd1), pm.extra_phases(None, ps, 1, ptd1)
    assert len(pm.stage2_losses) == len(jm._stage2_losses) == 2
    np.testing.assert_allclose(pm.stage2_losses, jm._stage2_losses, atol=TOL, rtol=0)
    for key in ("alphas", "betas"):
        np.testing.assert_allclose(ps.mvars[key].numpy(), np.asarray(js.mvars[key]), atol=1e-6,
                                   rtol=0, err_msg=key)
    assert float(ps.mvars["alphas"][1]) != 1.0 and float(ps.mvars["betas"][1]) != 0.0


@pytest.mark.parametrize("weight_align", [False, True])
def test_der_warm_start_and_weight_align(weight_align):
    jm, js, pm, ps = _common("DER", weight_align=weight_align)
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    js, ps = jm.before_task(js, 1, None), pm.before_task(ps, 1, None)
    ext = ps.params["backbone"]
    assert ps.mvars["n_active"] == 2
    for (k, a), (_, b) in zip(ext[0].state_dict().items(), ext[1].state_dict().items()):
        assert torch.equal(a, b), k
    # the warm-started slot equals the JAX stack's, parameters and statistics
    load_method_state(pm, ps, _numpy(js.params), _numpy(js.mvars))  # the fresh aux head
    _assert_state(js, ps, atol=0)
    ps = pm.reset_optimizer(ps, 1)
    trained = {id(p) for p in ps.opt_state.param_groups[0]["params"]}
    assert trained == {id(p) for p in [*ext[1].parameters(), *ps.params["head"].parameters(),
                                       *ps.params["aux"].parameters()]}
    before = ps.params["head"].dense.weight.detach().clone()
    js, ps = jm.after_task(js, 1, None), pm.after_task(ps, 1, None)
    w = ps.params["head"].dense.weight.detach()
    np.testing.assert_allclose(w.T.numpy(), np.asarray(js.params["head"]["Dense_0"]["kernel"]),
                               atol=1e-6, rtol=0)
    assert torch.equal(w, before) != weight_align


def test_der_eval_and_herding_features():
    jm, js, pm, ps = _common("DER")
    jb, pb = _batch(21, 0, 8)
    jx, px = jm.augment(None, jb["image"], train=False), pm.augment(None, pb["image"], False)
    with torch.no_grad():
        feats = pm.herding_features(ps, px)
        logits = pm.eval_logits(ps, px, -1)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jm.herding_features(js, jx)),
                               atol=TOL, rtol=0)
    assert feats.shape == (8, 64) and bool((feats[:, 32:] == 0).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm.eval_logits(js, jx, -1)), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name", ["LUCIR", "DER"])
def test_frozen_entries_are_bitwise_unchanged_under_weight_decay(name):
    """With weight decay 5e-4 on: LUCIR's old head rows and DER's old
    extractor (parameters and running statistics) keep their bits through
    a task-1 step; what trains moves."""
    jm, js, pm, ps = _methods(name)
    assert ps.opt_state.param_groups[0]["weight_decay"] == 5e-4
    js, ps = _to_task1(jm, js, pm, ps)
    head = ps.params["head"].weight if name == "LUCIR" else None
    frozen = ({"head_old": head[:4]} if name == "LUCIR"
              else ps.params["backbone"][0].state_dict())
    moving = ({"head_new": head[4:]} if name == "LUCIR"
              else dict(ps.params["backbone"][1].named_parameters()))
    frozen = {k: v.detach().clone() for k, v in frozen.items()}
    moving = {k: v.detach().clone() for k, v in moving.items()}
    _, pb = _batch(12, 0, 8)
    for _ in range(2):
        ps, _ = pm.train_step(ps, pb, 0.05)
    now = ({"head_old": head[:4]} if name == "LUCIR" else ps.params["backbone"][0].state_dict())
    for k, v in frozen.items():
        assert torch.equal(now[k], v), k
    now = ({"head_new": head[4:]} if name == "LUCIR"
           else dict(ps.params["backbone"][1].named_parameters()))
    assert all(not torch.equal(now[k], v) for k, v in moving.items())


def test_methods_and_backbones_resolve():
    from libcontinual_tpu_torch.registry import BACKBONES

    for name in NAMES:
        assert METHODS.get(name).__name__ == JAX_METHODS.get(name).__name__
    for name in ("resnet50", "cifar_resnet32_V2", "cifar_resnet32_bic", "resnet18_cbam",
                 "tiny_cnn"):
        assert isinstance(BACKBONES.get(name)(dtype=torch.float32), torch.nn.Module)


def test_task_range_mask_matches():
    jm, _, pm, _ = _methods("WA")
    for t in (-1, 0, 1):
        np.testing.assert_array_equal(pm.task_range_mask(t).numpy(),
                                      np.asarray(jm.task_range_mask(jnp.asarray(t))))
