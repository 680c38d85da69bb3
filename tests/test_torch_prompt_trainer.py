"""The port's trainer against the JAX trainer for the prefix-KV prompt
family and DAP: 2-task micro-runs of DualPrompt, CODA-Prompt and DAP (on
long-tailed ``imb_type`` streams) on ``vit_tiny_test`` in float32, from
the same initial weights, with the same batch order, compared epoch by
epoch and on the final acc table. The runs go through ``before_task`` at
each task start (CODA's re-orthogonalised pool slice, DAP's anchors), so a
trainer that skips the hook diverges from task 1 on."""

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
#: and the drift grows over the run's Adam steps
LOSS_TOL = 1e-4

KWARGS = {
    "DualPrompt": {"e_prompt_length": 4, "g_prompt_length": 2, "pool_size": 2},
    "CodaPrompt": {"prompt_length": 4, "pool_size": 4, "mu": 0.1},
    "DAP": {"length": 3, "top_k": 1},
}
#: (method, stream). DAP's stability term weighs ``alpha = (n_last - n_min) /
#: (n_max - n_min)``: 0 on ``exp``, where each task is smaller than the last,
#: and 1 at task 1 on ``exp_re``, where the prompt centre enters the loss.
CASES = [("DualPrompt", {}), ("CodaPrompt", {}),
         ("DAP", {"imb_type": "exp", "imb_factor": 0.1}),
         ("DAP", {"imb_type": "exp_re", "imb_factor": 0.1})]


def _overrides(name, extra):
    kwargs = KWARGS[name]
    return {
        "dataset": "synthetic", "data_root": "", "image_size": 32,
        "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4,
        "epoch": 1, "batch_size": 16, "per_class": 20, "seed": 7,
        "val_per_epoch": 0, "testing_times": 1, "dtype": "float32",
        "augment": False, "mesh": {"data": 1, "model": 1},
        "backbone": {"name": "vit_tiny_test", "kwargs": {}},
        "classifier": {"name": name, "kwargs": {
            "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4,
            "task_num": 2, **kwargs}},
        "train_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
        "test_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
        "buffer": {"name": "LinearBuffer",
                   "kwargs": {"buffer_size": 0, "batch_size": 16, "strategy": "random"}},
        # eps 1e-6: see LR, ADAM_EPS in test_torch_prompt_methods.py
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001, "eps": 1e-6}},
        "lr_scheduler": {"name": "Constant"}, "warmup": 0,
        **extra,
    }


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


@pytest.mark.parametrize("name,extra", CASES,
                         ids=[c[0] + "".join("-" + v for v in c[1].values() if isinstance(v, str))
                              for c in CASES])
def test_prompt_two_task_trainer_matches_jax(name, extra):
    over = _overrides(name, extra)
    jax_tr = JaxTrainer(JaxConfig(overrides=copy.deepcopy(over)).get_config_dict())
    port = Trainer(Config(overrides=copy.deepcopy(over)).get_config_dict(), device="cpu")
    port.state = prompt_state_from_flax(
        port.method, _numpy_tree(jax_tr.state.params),
        _numpy_tree(jax_tr.state.mvars["frozen"]), seed=7,
    )
    sizes = [len(port.train_stream.task(t)) for t in range(2)]
    assert sizes == [len(jax_tr.train_stream.task(t)) for t in range(2)]
    frozen_before = {k: v.clone() for k, v in port.state.mvars["frozen"].state_dict().items()}

    jax_losses, port_losses = [], []
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_losses.append(np.asarray(losses))
    port.epoch_hook = lambda t, e, s, losses: port_losses.append(np.asarray(losses))
    jax_res = jax_tr.train_loop()
    port_res = port.train_loop()

    assert len(port_losses) == len(jax_losses) == 2  # 2 tasks x 1 epoch
    for ep, (a, b) in enumerate(zip(jax_losses, port_losses)):
        np.testing.assert_allclose(b, a, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    for k, v in port.state.mvars["frozen"].state_dict().items():
        assert torch.equal(v, frozen_before[k]), k
    if name == "DAP":
        assert sizes[0] != sizes[1]  # the long-tailed stream
        for key in ("alpha", "prompt_center"):
            np.testing.assert_allclose(port.state.mvars[key].numpy(),
                                       np.asarray(jax_tr.state.mvars[key]), atol=1e-5)
