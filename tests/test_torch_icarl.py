"""The port's iCaRL against the JAX package's on ``cifar_resnet20`` at 8x8
in float32, from the same weights (the JAX state converted): the loss and
its gradients, one SGD step with momentum and weight decay (parameters and
BatchNorm statistics), the KD term at task 1 and ``kd_loss`` itself, the
class means after ``on_buffer_updated``, the choice between NME and the
logits in ``eval_logits``, and the teacher's running statistics, which its
train-mode forward leaves alone. Finetune's default loss too."""

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
from libcontinual_tpu.core.buffer import LinearBuffer as JaxBuffer  # noqa: E402
from libcontinual_tpu.methods.common import kd_loss as jax_kd_loss  # noqa: E402
from libcontinual_tpu.registry import METHODS as JAX_METHODS  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import resnet_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.core.buffer import LinearBuffer  # noqa: E402
from libcontinual_tpu_torch.methods.common import kd_loss  # noqa: E402
from libcontinual_tpu_torch.registry import METHODS  # noqa: E402

#: float32 losses, class means and eval scores (relative, for logits of
#: magnitude 10-20): sums in another order
TOL = 1e-5
#: gradients and one SGD step through 19 conv / BatchNorm layers
GRAD_TOL = 1e-4

NORM = [{"Normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]}}]
OVERRIDES = {
    "dataset": "synthetic", "data_root": "", "image_size": 8, "task_num": 2,
    "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 8, "seed": 3, "dtype": "float32",
    "augment": False, "train_trfms": NORM, "test_trfms": NORM,
    "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "cifar_resnet20", "kwargs": {}},
    "classifier": {"name": "ICarl", "kwargs": {
        "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4, "task_num": 2}},
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9, "weight_decay": 5e-4}},
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _methods(name="ICarl"):
    ov = copy.deepcopy(OVERRIDES)
    ov["classifier"]["name"] = name
    jm = JAX_METHODS.get(name)(JaxConfig(overrides=copy.deepcopy(ov)).get_config_dict())
    pm = METHODS.get(name)(Config(overrides=ov).get_config_dict(), "cpu")
    js = jm.init_state(jax.random.PRNGKey(0), (8, 8, 3))
    ps = resnet_state_from_flax(pm, _numpy(js.params), _numpy(js.mvars))
    return jm, js, pm, ps


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


def _loss_and_grads(jm, js, pm, ps, jb, pb):
    jb = dict(jb, x=jm.augment(None, jb["image"], train=False))
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss(p, js, jb, None), has_aux=True)(js.params)
    pb = dict(pb, x=pm.augment(None, pb["image"], train=False))
    ps.params.zero_grad(set_to_none=True)
    stats = {k: v.clone() for k, v in ps.params.named_buffers()}
    pl, _ = pm.loss(ps, pb)
    pl.backward()
    # the JAX loss returns its new statistics; the port's updates them in
    # place, and the train step that follows updates them again
    for k, v in ps.params.named_buffers():
        v.copy_(stats[k])
    return float(jl), float(pl.detach()), _numpy(jg), ps.params


def _assert_grads(jg, params):
    bb = params["backbone"]
    pairs = [(params["head"].dense.weight.grad.T, jg["head"]["Dense_0"]["kernel"]),
             (bb.conv_stem.weight.grad.permute(2, 3, 1, 0), jg["backbone"]["conv_stem"]["kernel"]),
             (bb.blocks[4].bn1.weight.grad, jg["backbone"]["BasicBlock_4"]["BatchNorm_1"]["scale"]),
             (bb.blocks[8].conv1.weight.grad.permute(2, 3, 1, 0),
              jg["backbone"]["BasicBlock_8"]["Conv_1"]["kernel"])]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), ref, atol=GRAD_TOL, rtol=0)


def _assert_params(js, ps):
    jp = _numpy(js.params)
    bb = ps.params["backbone"]
    np.testing.assert_allclose(ps.params["head"].dense.weight.detach().T.numpy(),
                               jp["head"]["Dense_0"]["kernel"], atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(bb.conv_stem.weight.detach().permute(2, 3, 1, 0).numpy(),
                               jp["backbone"]["conv_stem"]["kernel"], atol=GRAD_TOL, rtol=0)
    stats = _numpy(js.mvars["model_state"]["batch_stats"])
    for bn, ref in ((bb.bn_stem, stats["bn_stem"]),
                    (bb.blocks[8].bn1, stats["BasicBlock_8"]["BatchNorm_1"])):
        np.testing.assert_allclose(bn.running_mean.numpy(), ref["mean"], atol=GRAD_TOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), ref["var"], atol=GRAD_TOL, rtol=1e-5)


@pytest.mark.parametrize("name", ["ICarl", "Finetune"])
def test_task0_loss_grads_and_step(name):
    jm, js, pm, ps = _methods(name)
    jb, pb = _batch(0)
    jl, pl, jg, params = _loss_and_grads(jm, js, pm, ps, jb, pb)
    assert abs(pl - jl) <= TOL
    _assert_grads(jg, params)
    js, jmet = jm.train_step(js, jb, 0.05)
    ps, pmet = pm.train_step(ps, pb, 0.05)
    assert abs(float(pmet["loss"]) - float(jmet["loss"])) <= TOL
    assert float(pmet["acc"]) == float(jmet["acc"])
    _assert_params(js, ps)


def test_kd_term_at_task1_and_teacher_statistics():
    jm, js, pm, ps = _methods()
    jb, pb = _batch(1)
    js, _ = jm.train_step(js, jb, 0.05)
    ps, _ = pm.train_step(ps, pb, 0.05)
    js, ps = jm.after_task(js, 0, None), pm.after_task(ps, 0, None)
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    js, ps = jm.reset_optimizer(js, 1), pm.reset_optimizer(ps, 1)
    teacher = ps.mvars["teacher"]["backbone"]
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    for step in range(2):  # the second step's student has moved from its teacher
        jb, pb = _batch(10 + step, 0, 8)
        jl, pl, jg, params = _loss_and_grads(jm, js, pm, ps, jb, pb)
        assert abs(pl - jl) <= TOL, step
        _assert_grads(jg, params)
        js, _ = jm.train_step(js, jb, 0.05)
        ps, _ = pm.train_step(ps, pb, 0.05)
    _assert_params(js, ps)
    after = teacher.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert not teacher.bn_stem.weight.requires_grad


@pytest.mark.parametrize("masked", [False, True])
def test_kd_loss_matches(masked):
    rng = np.random.RandomState(4)
    pred, soft = (rng.randn(6, 10).astype(np.float32) * 3 for _ in range(2))
    mask = (np.arange(10) < 4).astype(np.float32) if masked else None
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32)
    ref = jax_kd_loss(jnp.asarray(pred), jnp.asarray(soft), 2.0,
                      None if mask is None else jnp.asarray(mask), jnp.asarray(weight))
    got = kd_loss(torch.from_numpy(pred), torch.from_numpy(soft), 2.0,
                  None if mask is None else torch.from_numpy(mask), torch.from_numpy(weight))
    assert abs(float(got) - float(ref)) <= TOL


def _buffers(classes, per_class=3, seed=5):
    rng = np.random.RandomState(seed)
    labels = np.repeat(np.asarray(classes), per_class).astype(np.int32)
    images = rng.randint(0, 256, (len(labels), 8, 8, 3)).astype(np.uint8)
    bufs = []
    for cls in (JaxBuffer, LinearBuffer):
        buf = cls(buffer_size=len(labels))
        buf.images, buf.labels = images, labels
        bufs.append(buf)
    return bufs


def _eval(jm, js, pm, ps, seed):
    jb, pb = _batch(seed, 0, 8)
    jl = np.asarray(jm.eval_logits(js, jm.augment(None, jb["image"], train=False), -1))
    with torch.no_grad():
        pl = pm.eval_logits(ps, pm.augment(None, pb["image"], train=False), -1).numpy()
    return jl, pl


def test_class_means_and_nme_selection():
    jm, js, pm, ps = _methods()
    # before any buffer: the masked logits
    jl, pl = _eval(jm, js, pm, ps, 20)
    np.testing.assert_allclose(pl, jl, atol=TOL, rtol=TOL)
    assert (pl[:, 4:] == -1e30).all()
    jbuf, pbuf = _buffers([0, 1, 2, 3])  # 12 exemplars: a padded second batch of 8
    js, ps = jm.on_buffer_updated(js, 0, jbuf), pm.on_buffer_updated(ps, 0, pbuf)
    np.testing.assert_allclose(ps.mvars["class_means"].numpy(),
                               np.asarray(js.mvars["class_means"]), atol=TOL, rtol=0)
    np.testing.assert_array_equal(ps.mvars["mean_valid"].numpy(), np.asarray(js.mvars["mean_valid"]))
    assert ps.mvars["nme_ready"]
    # task 0: the means cover every seen class, so NME (negative distances)
    jl, pl = _eval(jm, js, pm, ps, 21)
    np.testing.assert_allclose(pl, jl, atol=TOL, rtol=TOL)
    assert (pl[:, :4] <= 0).all()
    # task 1 before its buffer update: classes 4-7 have no mean, so the logits
    js, ps = jm.start_task(js, 1, 4, 8), pm.start_task(ps, 1, 4, 8)
    jl, pl = _eval(jm, js, pm, ps, 22)
    np.testing.assert_allclose(pl, jl, atol=TOL, rtol=TOL)
    logits = pm.forward(ps.params, pm.augment(None, _batch(22, 0, 8)[1]["image"], train=False),
                        train=False)[0]
    np.testing.assert_allclose(pl, logits.detach().numpy(), atol=0, rtol=0)
    jbuf, pbuf = _buffers(list(range(8)), per_class=2, seed=6)
    js, ps = jm.on_buffer_updated(js, 1, jbuf), pm.on_buffer_updated(ps, 1, pbuf)
    jl, pl = _eval(jm, js, pm, ps, 23)
    np.testing.assert_allclose(pl, jl, atol=TOL, rtol=TOL)
    assert (pl <= 0).all()


@pytest.mark.parametrize("backbone,dim", [("cifar_resnet20", 64), ("cifar_resnet32", 64),
                                          ("resnet18", 512), ("resnet18_AML", 160)])
def test_feat_dim_from_the_backbone_table(backbone, dim):
    """Without ``feat_dim`` in the classifier's kwargs the width comes from the
    ResNet table, as in the JAX package; a backbone outside the table raises
    rather than building a zero-width head."""
    ov = copy.deepcopy(OVERRIDES)
    ov["backbone"]["name"] = backbone
    del ov["classifier"]["kwargs"]["feat_dim"]
    jm = JAX_METHODS.get("ICarl")(JaxConfig(overrides=copy.deepcopy(ov)).get_config_dict())
    pm = METHODS.get("ICarl")(Config(overrides=ov).get_config_dict(), "cpu")
    assert pm.feat_dim == jm.feat_dim == dim
    pm.config["backbone"]["name"] = "no_such_resnet"
    with pytest.raises(ValueError, match="feat_dim"):
        pm.feat_dim
