"""The port's trainer against the JAX trainer for the classic ResNet methods:
2-task EWC, LwF, WA, LUCIR, BiC and DER micro-runs on ``cifar_resnet20``
(DER: ``tiny_cnn`` extractors) at 8x8 in float32, from the same initial
weights (the JAX trainer's initial state converted) and the same batch order.

The run is piecewise, as in ``test_torch_rehearsal_trainer.py``: momentum SGD
on a BatchNorm net amplifies float noise several times a step, so at the end
of every port epoch its parameters and running statistics are compared with
the JAX ones and then replaced by them. Each task boundary (EWC's Fisher,
WA's alignment, LUCIR's imprinting, BiC's split and stage 2, DER's warm start,
the teachers, the herding buffer) then runs on the port's own code from the
JAX weights. Per-step losses agree within ``LOSS_TOL``, the buffer and the
acc table exactly, and what each method keeps (Fisher, bias layers, frozen
rows and extractors) as stated at each check."""

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
from libcontinual_tpu_torch.convert import (  # noqa: E402
    load_backbone_params, load_head, named_like, resnet_state_from_flax)
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402

#: per-step losses within one epoch from a common start, f32 on the CPU
LOSS_TOL = 1e-4
#: parameters at an epoch's end, after three steps of momentum SGD
PARAM_TOL = 1e-3
#: EWC's Fisher, relative (the JAX package's EWC lockstep figure)
FISHER_RTOL, FISHER_ATOL = 5e-3, 1e-9

NORM = [{"Normalize": {"mean": [0.5071, 0.4866, 0.4409], "std": [0.2675, 0.2565, 0.2761]}}]
BASE = {
    "dataset": "synthetic", "data_root": "", "image_size": 8,
    "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4,
    "epoch": 1, "batch_size": 16, "per_class": 10, "seed": 11,
    "val_per_epoch": 0, "testing_times": 1, "dtype": "float32",
    "augment": False, "train_trfms": NORM, "test_trfms": NORM, "stage2_epoch": 2,
    "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "cifar_resnet20", "kwargs": {}},
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.01, "momentum": 0.9, "weight_decay": 5e-4}},
    "lr_scheduler": {"name": "Constant"}, "warmup": 0,
}
_HERDING = {"name": "LinearHerdingBuffer", "kwargs": {"buffer_size": 8, "batch_size": 16}}
METHOD = {
    "EWC": {},
    "LWF": {},
    "WA": {"buffer": _HERDING},
    "LUCIR": {"buffer": _HERDING},
    "bic": {"buffer": {"name": "LinearSpiltBuffer", "kwargs": {
        "buffer_size": 8, "batch_size": 16, "strategy": "herding", "split_ratio": 0.25}}},
    "DER": {"buffer": _HERDING, "backbone": {"name": "tiny_cnn", "kwargs": {}}},
}
#: training steps a task, in batches of 16: 40 images (BiC: 36, one a class
#: held out), then 40 (EWC, LwF: no replay), 40 + 8 exemplars, or BiC's 36 +
#: the buffer's 4 train exemplars
STEPS = [3, 3]


def _config(name):
    cfg = copy.deepcopy(BASE)
    cfg.update(copy.deepcopy(METHOD[name]))
    feat = 32 if name == "DER" else 64
    cfg["classifier"] = {"name": name, "kwargs": {
        "num_class": 8, "feat_dim": feat, "init_cls_num": 4, "inc_cls_num": 4, "task_num": 2}}
    return cfg


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("name", list(METHOD))
def test_classic_two_task_trainer_matches_jax(name):
    jax_tr = JaxTrainer(JaxConfig(overrides=_config(name)).get_config_dict())
    port = Trainer(Config(overrides=_config(name)).get_config_dict(), device="cpu")
    port.state = resnet_state_from_flax(port.method, _numpy(jax_tr.state.params),
                                        _numpy(jax_tr.state.mvars), seed=11)

    jax_epochs, jax_aux = [], []
    if name == "DER":  # the aux head drawn anew at task 1: JAX's draw, fed to the port
        jax_before = jax_tr.method.before_task

        def record_aux(state, task_idx, task_data):
            state = jax_before(state, task_idx, task_data)
            jax_aux.append(_numpy(state.params["aux"]))
            return state
        jax_tr.method.before_task = record_aux
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_epochs.append(
        (np.asarray(losses), _numpy(s.params), _numpy(s.mvars["model_state"]["batch_stats"])))
    jax_res = jax_tr.train_loop()

    port_losses, frozen = [], {}

    def resync(t, e, state, losses):
        _, params, stats = jax_epochs[len(port_losses)]
        port_losses.append(np.asarray(losses))
        ref = named_like(state.params, params, stats)
        for k, p in state.params.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), atol=PARAM_TOL,
                                       err_msg=f"task {t} {k}")
        if name == "DER" and t == 1:  # extractor 0 kept its task-0 bits
            now = state.params["backbone"][0].state_dict()
            assert all(torch.equal(v, now[k]) for k, v in frozen.items())
        if name == "LUCIR" and t == 1:  # the old rows kept their imprint-time bits
            assert torch.equal(state.params["head"].weight[:4], frozen["head"])
        load_backbone_params(state.params, params, stats)
        if name == "DER" and t == 0:
            old = state.params["backbone"][0].state_dict()
            frozen.update({k: v.clone() for k, v in old.items()})

    port.epoch_hook = resync
    port_before = port.method.before_task

    def at_task_start(state, task_idx, task_data):
        state = port_before(state, task_idx, task_data)
        if name == "LUCIR":  # the old rows as task 1 starts
            frozen["head"] = state.params["head"].weight[:4].detach().clone()
        if name == "DER":
            load_head(state.params["aux"], jax_aux[task_idx], "aux")
        return state
    port.method.before_task = at_task_start
    port_res = port.train_loop()

    assert [len(x) for x in port_losses] == STEPS
    assert len(jax_epochs) == len(port_losses)
    for ep, ((ref, _, _), got) in enumerate(zip(jax_epochs, port_losses)):
        np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    if port.method.concat_buffer:
        np.testing.assert_array_equal(port.buffer.labels, jax_tr.buffer.labels)
        np.testing.assert_array_equal(port.buffer.images, jax_tr.buffer.images)
        assert len(port.buffer.labels) == 8
    mv, jmv = port.state.mvars, jax_tr.state.mvars
    if name == "EWC":
        stats = _numpy(jax_tr.state.mvars["model_state"]["batch_stats"])
        ref = named_like(port.state.params, _numpy(jmv["fisher"]), stats)
        for k, v in ref.items():
            np.testing.assert_allclose(mv["fisher"][k].numpy(), v.numpy(), atol=FISHER_ATOL,
                                       rtol=FISHER_RTOL, err_msg=k)
    if name == "bic":
        assert len(port.method.stage2_losses) == len(jax_tr.method._stage2_losses) > 0
        np.testing.assert_allclose(port.method.stage2_losses, jax_tr.method._stage2_losses,
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for key in ("alphas", "betas"):
            np.testing.assert_allclose(mv[key].numpy(), np.asarray(jmv[key]), atol=1e-4,
                                       err_msg=key)
    if name == "LUCIR":
        assert abs(mv["cur_lamda"] - float(jmv["cur_lamda"])) < 1e-6
    if name == "DER":
        assert mv["n_active"] == int(np.asarray(jmv["active"]).sum()) == 2
