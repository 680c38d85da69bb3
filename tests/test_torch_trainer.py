"""The PyTorch port's trainer against the JAX trainer: a 2-task L2P
micro-run on ``vit_tiny_test`` in float32, from the same initial weights
(the JAX trainer's initial state converted into the port), with the same
batch order, compared epoch by epoch and on the final acc table."""

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
from libcontinual_tpu_torch.convert import prompt_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402

#: per-step losses, f32 on the CPU: the two frameworks sum in other orders,
#: and the drift grows over the run's Adam steps (measured below 1e-5)
LOSS_TOL = 1e-4

OVERRIDES = {
    "dataset": "synthetic", "data_root": "", "image_size": 32,
    "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4,
    "epoch": 2, "batch_size": 16, "per_class": 24, "seed": 7,
    "val_per_epoch": 0, "testing_times": 1, "dtype": "float32",
    "augment": False, "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "vit_tiny_test", "kwargs": {}},
    "classifier": {"name": "L2P", "kwargs": {
        "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4,
        "task_num": 2, "prompt_length": 3, "pool_size": 6, "top_k": 2,
        "pull_constraint_coeff": 0.1}},
    "train_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
    "test_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
    "buffer": {"name": "LinearBuffer",
               "kwargs": {"buffer_size": 0, "batch_size": 16, "strategy": "random"}},
    "optimizer": {"name": "Adam", "kwargs": {"lr": 0.01}},
    "lr_scheduler": {"name": "Constant"}, "warmup": 0,
}


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


def test_l2p_two_task_trainer_matches_jax():
    jax_tr = JaxTrainer(JaxConfig(overrides=copy.deepcopy(OVERRIDES)).get_config_dict())
    port = Trainer(Config(overrides=copy.deepcopy(OVERRIDES)).get_config_dict(), device="cpu")
    port.state = prompt_state_from_flax(
        port.method, _numpy_tree(jax_tr.state.params),
        _numpy_tree(jax_tr.state.mvars["frozen"]), seed=7,
    )
    frozen_before = {k: v.clone() for k, v in port.state.mvars["frozen"].state_dict().items()}

    jax_losses, port_losses = [], []
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_losses.append(np.asarray(losses))
    port.epoch_hook = lambda t, e, s, losses: port_losses.append(np.asarray(losses))
    jax_res = jax_tr.train_loop()
    port_res = port.train_loop()

    assert len(port_losses) == len(jax_losses) == 4  # 2 tasks x 2 epochs
    for ep, (a, b) in enumerate(zip(jax_losses, port_losses)):
        np.testing.assert_allclose(b, a, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    assert port_res["acc_table"][1, :2].min() >= 0.0
    for k, v in port.state.mvars["frozen"].state_dict().items():
        assert torch.equal(v, frozen_before[k]), k


@pytest.mark.parametrize("epochs", [0, 1])
def test_trainer_fills_acc_table(epochs):
    cfg = Config(overrides=dict(copy.deepcopy(OVERRIDES), epoch=epochs)).get_config_dict()
    res = Trainer(cfg, device="cpu").train_loop()
    table = res["acc_table"]
    assert table.shape == (2, 2)
    assert np.isfinite(table).all() and table[1, 1] >= 0.0 and table[0, 1] == 0.0
    assert res["fps"] > 0
