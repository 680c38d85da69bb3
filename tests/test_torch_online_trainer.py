"""The port's trainer against the JAX trainer for the online methods: 2-task
ER-ACE, ER-AML (as shipped, and with the class-balanced buffer, the balanced
sampler and the in-batch mining, not task-free), OCM and PRAKA micro-runs at
8x8 in float32 (``tests/test_torch_online_methods.py``'s configs: ER on
``resnet18_AML``, a buffer of 16; OCM and PRAKA on ``tiny_cnn``), from the
same initial weights
(the JAX trainer's initial state converted), the same batch order and the
JAX run's own draws, rebuilt from its key chain and fed to the port's
``draw`` a step at a time. OCM's SimCLR pipeline is one deterministic
function on both sides.

Each task is 20 images in batches of 8, so its last batch carries 4 padded
rows, which neither enter the buffer nor count in ``n_seen``. As in
``tests/test_torch_classic_trainer.py``, at the end of every port epoch its
parameters and running statistics are compared with the JAX ones and its
buffer bitwise, then all are replaced by the JAX ones: momentum SGD on a
BatchNorm net amplifies float noise. Each task boundary (``seen_so_far``,
the teachers, PRAKA's prototypes) then runs on the port's own code. Per-step
losses agree within ``LOSS_TOL`` and the acc table exactly. Also: the
trainer skips the per-epoch validation for PRAKA and keeps it for a method
with the default."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.core.trainer import Trainer as JaxTrainer  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import (  # noqa: E402
    load_method_state, named_like, resnet_state_from_flax)
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402
from test_torch_online_methods import (  # noqa: E402
    config, feed_jax_draws, jax_simclr, port_simclr)

#: per-step losses within one epoch from a common start, f32 on the CPU
LOSS_TOL = 1e-4
#: parameters at an epoch's end, after three steps of momentum SGD
PARAM_TOL = 1e-3

RUN = {"epoch": 1, "per_class": 5, "seed": 11, "val_per_epoch": 0, "testing_times": 1,
       "lr_scheduler": {"name": "Constant"}, "warmup": 0}
CASES = ["ERACE", "ERAML", "ERAML-balanced-minimal", "OCM", "PRAKA"]


def _numpy(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


@pytest.mark.parametrize("case", CASES)
def test_online_two_task_trainer_matches_jax(case):
    ov = config(case, **RUN)
    jax_tr = JaxTrainer(JaxConfig(overrides=ov).get_config_dict())
    port = Trainer(Config(overrides=config(case, **RUN)).get_config_dict(), device="cpu")
    if case == "OCM":
        jax_tr.method._simclr_aug, port.method.simclr_aug = jax_simclr, port_simclr
    port.state = resnet_state_from_flax(port.method, _numpy(jax_tr.state.params),
                                        _numpy(jax_tr.state.mvars), seed=11)
    # the JAX trainer donates its state's buffers: copy the key first
    feed_jax_draws(port.method, jax_tr.method, np.array(jax_tr.state.rng))

    jax_epochs = []
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_epochs.append(
        (np.asarray(losses), _numpy(s.params), _numpy(s.mvars)))
    jax_res = jax_tr.train_loop()

    port_losses = []

    def resync(t, e, state, losses):
        _, params, mvars = jax_epochs[len(port_losses)]
        port_losses.append(np.asarray(losses))
        stats = mvars["model_state"]["batch_stats"]
        ref = named_like(state.params, params, stats)
        for k, p in state.params.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), atol=PARAM_TOL,
                                       err_msg=f"task {t} {k}")
        for k, v in state.mvars.get("buffer", {}).items():
            np.testing.assert_array_equal(v.numpy(), mvars["buffer"][k], err_msg=f"task {t} {k}")
        load_method_state(port.method, state, params, mvars)

    port.epoch_hook = resync
    port_res = port.train_loop()

    assert [len(x) for x in port_losses] == [3, 3] and len(jax_epochs) == 2
    for ep, ((ref, _, _), got) in enumerate(zip(jax_epochs, port_losses)):
        np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    mv, jmv = port.state.mvars, _numpy(jax_tr.state.mvars)
    if "buffer" in mv:  # every weight-1 image counted, none of the 8 padded rows
        assert int(mv["buffer"]["n_seen"]) == int(jmv["buffer"]["n_seen"]) == 40
        for k, v in mv["buffer"].items():
            np.testing.assert_array_equal(v.numpy(), jmv["buffer"][k], err_msg=k)
    if case.startswith("ER"):
        assert mv["seen_so_far"] == int(jmv["seen_so_far"]) == 8
    if case == "PRAKA":
        np.testing.assert_array_equal(mv["proto_valid"].numpy(), jmv["proto_valid"])
        assert float(mv["proto_valid"].sum()) == 8.0
        np.testing.assert_allclose(mv["protos"].numpy(), jmv["protos"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["PRAKA", "Finetune"])
def test_trainer_skips_validation_only_where_the_method_says(name):
    """Two tasks of 2 epochs: the trainer validates at each task's end, and
    after the first epoch too unless the method sets ``validate_enabled =
    False`` (PRAKA)."""
    ov = config("PRAKA", **dict(RUN, epoch=2, val_per_epoch=1))
    ov["classifier"]["name"] = name
    trainer = Trainer(Config(overrides=ov).get_config_dict(), device="cpu")
    calls = []
    validate = trainer._validate
    trainer._validate = lambda t: calls.append(t) or validate(t)
    trainer.train_loop()
    assert trainer.method.validate_enabled == (name != "PRAKA")
    assert calls == ([0, 1] if name == "PRAKA" else [0, 0, 1, 1])
