"""The port's trainer against the JAX trainer on the rehearsal path: 2-task
iCaRL (herding buffer, KD teacher, NME evaluation) and Finetune (random
buffer) micro-runs on ``cifar_resnet20`` at 8x8 in float32, from the same
initial weights (the JAX trainer's initial state converted) and the same
batch order.

Momentum SGD on a BatchNorm net amplifies float noise several times a step,
so the run is piecewise: the JAX trainer runs first and records its state at
the end of every epoch; the port runs next, and at the end of each of its
epochs its parameters and running statistics are compared with the JAX
ones and then replaced by them. Every epoch thus starts from a common state,
drift never spans more than one epoch, and the task boundary (teacher
snapshot, herding features, class means) sees the JAX weights. Per-step
losses agree within ``LOSS_TOL``; the buffer's labels and pixels and the acc
table agree exactly."""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.core.trainer import Trainer as JaxTrainer  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import load_backbone_params, resnet_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402

#: per-step losses within one epoch from a common start, f32 on the CPU
LOSS_TOL = 1e-4
#: parameters at an epoch's end, after three steps of momentum SGD
PARAM_TOL = 1e-3

NORM = [{"Normalize": {"mean": [0.5071, 0.4866, 0.4409], "std": [0.2675, 0.2565, 0.2761]}}]
BASE = {
    "dataset": "synthetic", "data_root": "", "image_size": 8,
    "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4,
    "epoch": 1, "batch_size": 16, "per_class": 10, "seed": 11,
    "val_per_epoch": 0, "testing_times": 1, "dtype": "float32",
    "augment": False, "train_trfms": NORM, "test_trfms": NORM,
    "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "cifar_resnet20", "kwargs": {}},
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.01, "momentum": 0.9, "weight_decay": 5e-4}},
    "lr_scheduler": {"name": "Constant"}, "warmup": 0,
}
METHOD = {
    "ICarl": {"buffer": {"name": "LinearHerdingBuffer",
                         "kwargs": {"buffer_size": 8, "batch_size": 16}}},
    "Finetune": {"buffer": {"name": "LinearBuffer",
                            "kwargs": {"buffer_size": 8, "batch_size": 16, "strategy": "random"}}},
}


def _config(name):
    cfg = copy.deepcopy(BASE)
    cfg.update(copy.deepcopy(METHOD[name]))
    cfg["classifier"] = {"name": name, "kwargs": {
        "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4, "task_num": 2}}
    return cfg


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("name", ["ICarl", "Finetune"])
def test_rehearsal_two_task_trainer_matches_jax(name):
    jax_tr = JaxTrainer(JaxConfig(overrides=_config(name)).get_config_dict())
    port = Trainer(Config(overrides=_config(name)).get_config_dict(), device="cpu")
    port.state = resnet_state_from_flax(port.method, _numpy(jax_tr.state.params),
                                        _numpy(jax_tr.state.mvars), seed=11)

    jax_epochs = []
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_epochs.append(
        (np.asarray(losses), _numpy(s.params), _numpy(s.mvars["model_state"]["batch_stats"])))
    jax_res = jax_tr.train_loop()

    port_losses = []

    def resync(t, e, state, losses):
        _, params, stats = jax_epochs[len(port_losses)]
        port_losses.append(np.asarray(losses))
        head = state.params["head"].dense.weight.detach().T.numpy()
        np.testing.assert_allclose(head, params["head"]["Dense_0"]["kernel"], atol=PARAM_TOL)
        stem = state.params["backbone"].bn_stem
        np.testing.assert_allclose(stem.running_mean.numpy(), stats["bn_stem"]["mean"],
                                   atol=PARAM_TOL)
        load_backbone_params(state.params, params, stats)

    port.epoch_hook = resync
    port_res = port.train_loop()

    assert len(port_losses) == len(jax_epochs) == 2
    sizes = [len(l) for l in port_losses]
    assert sizes == [3, 3]  # 40 images, then 40 + 8 exemplars, in batches of 16
    for ep, ((ref, _, _), got) in enumerate(zip(jax_epochs, port_losses)):
        np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port.buffer.labels, jax_tr.buffer.labels)
    np.testing.assert_array_equal(port.buffer.images, jax_tr.buffer.images)
    assert len(port.buffer.labels) == 8
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    if name == "ICarl":
        # herding keeps buffer_size // seen classes exemplars of each class
        assert np.bincount(port.buffer.labels).tolist() == [1] * 8
        np.testing.assert_allclose(port.state.mvars["class_means"].numpy(),
                                   np.asarray(jax_tr.state.mvars["class_means"]), atol=1e-5)
        assert port.state.mvars["nme_ready"]
