"""The port's trainer against the JAX trainer for the gradient-projection
methods: 2-task GPM, TRGP, API (AlexNet at 32x32) and DMNSP (``vit_tiny_test``
with 8-wide adapters, through the packed attention's plain version) micro-runs
in float32, task-aware, from the same initial weights (the JAX trainer's
initial state converted), the same batch order and the JAX run's own dropout
masks, rebuilt from its key chain (``split(rng, 3)`` a step) and fed to the
port's ``draw`` a step at a time (``tests/test_torch_gradproj_methods.py``'s
configs: SGD 0.05, API with one stage-1 epoch; DMNSP's per-iteration
CosineAnnealingWarmUp schedule).

Each task is 20 images in batches of 8, so its last batch carries 4 padded
rows. As in ``tests/test_torch_classic_trainer.py``, at the end of every
port epoch its parameters are compared with the JAX ones and then replaced
by them (with the method variables and the host-side bases): float noise
through 5 batch normalisations grows step by step. Each task boundary runs
on the port's own code. API's expansion mixes are the top singular vectors
of an importance matrix, whose signs are arbitrary: the port's are held
against the JAX run's up to sign, then the JAX ones are fed (the kernel
rows they feed are not sign-symmetric); TRGP's scales Q are held as
``U (Q - I) U^T``, since their entries follow the signs of the port's own
task spaces U (the update itself does not). Per-step losses agree within
``LOSS_TOL`` and the acc table exactly (task-aware evaluation on the
batch's own statistics, the JAX trainer's wrapped last batch)."""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.core.trainer import Trainer as JaxTrainer  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402
from test_torch_alexnet import recorded_bernoulli  # noqa: E402
from test_torch_gradproj_methods import (  # noqa: E402
    JitEvalApplies, _numpy, config, gradproj_state_from_flax, host_state, load_gradproj_params,
    load_gradproj_state, port_draws)

#: per-step losses within one epoch from a common start, f32 on the CPU
LOSS_TOL = 1e-4
#: parameters at an epoch's end, after three SGD steps
PARAM_TOL = 1e-3

RUN = {"epoch": 1, "per_class": 5, "seed": 11, "val_per_epoch": 0, "testing_times": 1}
DMNSP_RUN = {"lr_scheduler": {"name": "CosineAnnealingWarmUp", "kwargs": {"warmup_length": 2}}}


def _scale_update(q, u) -> np.ndarray:
    """``U (Q - I) U^T``: what a TRGP scale does to a weight's rows, the same
    whatever the signs of U's columns (Q's entries are not)."""
    q, u = q.detach().double().numpy(), u.double().numpy()
    return u @ (q - np.eye(len(q))) @ u.T


def jax_mask_fn(jm, js):
    """``key -> the dropout masks of one training forward`` on the JAX
    backbone (shapes only: the masks depend on the key and the batch size)."""
    x = jnp.zeros((8, 32, 32, 3))
    params, mvars = _numpy(js.params), _numpy(js.mvars)  # the trainer donates its state
    if type(jm).__name__ == "DMNSP":
        variables = {"params": jm._full_vit_params(params, mvars)}
        args = ()
    else:
        variables = {"params": params["backbone"]}
        args = (mvars["ws_mask"],) if "ws_mask" in mvars else ()

    def masks(key):
        drawn = []
        with recorded_bernoulli(drawn):
            jm.backbone.apply(variables, x, *args, train=True, rngs={"dropout": key})
        return drawn

    return jax.jit(masks)


def feed_jax_draws(name, pm, jm, js):
    """Patch the port's ``draw`` to hand out the JAX run's dropout masks
    from the JAX state's key on, one step a call."""
    fn = jax_mask_fn(jm, js)
    box = [np.array(js.rng)]

    def draw(state, batch):
        rng, _, loss_rng = jax.random.split(box[0], 3)
        box[0] = rng
        return port_draws(name, fn(loss_rng))

    pm.draw = draw


@pytest.mark.parametrize("name", ["GPM", "TRGP", "API", "DMNSP"])
def test_gradproj_two_task_trainer_matches_jax(name):
    over = dict(RUN, **(DMNSP_RUN if name == "DMNSP" else {}))
    jax_tr = JaxTrainer(JaxConfig(overrides=config(name, **over)).get_config_dict())
    port = Trainer(Config(overrides=config(name, **over)).get_config_dict(), device="cpu")
    jm, pm = jax_tr.method, port.method
    jm.backbone = JitEvalApplies(jm.backbone)
    port.state = gradproj_state_from_flax(pm, _numpy(jax_tr.state.params),
                                          _numpy(jax_tr.state.mvars), host_state(jm), seed=11)
    feed_jax_draws(name, pm, jm, jax_tr.state)
    # the trainers' closing inference-speed probe (30 evaluation steps a
    # side) measures nothing that is compared here
    jax_tr._compute_fps = port._compute_fps = lambda: 0.0

    jax_epochs, jax_slabs = [], []
    if name == "API":  # the JAX run's expansion mixes, fed to the port after its own
        jax_before = jm.before_task

        def record_slabs(state, task_idx, task_data):
            state = jax_before(state, task_idx, task_data)
            jax_slabs.append((_numpy(state.params)["backbone"], np.array(jm._ws_counts),
                              None if jm.per_layer_retain is None else
                              np.array(jm.per_layer_retain)))
            return state
        jm.before_task = record_slabs
        jm.per_layer_retain = None
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_epochs.append(
        (np.asarray(losses), _numpy(s.params), _numpy(s.mvars), host_state(jm)))
    jax_res = jax_tr.train_loop()

    port_losses = []

    def resync(t, e, state, losses):
        _, params, mvars, host = jax_epochs[len(port_losses)]
        port_losses.append(np.asarray(losses))
        ref = copy.deepcopy(state.params)
        load_gradproj_params(ref, params)
        want = dict(ref.named_parameters())
        for k, p in state.params.named_parameters():
            if k.startswith("tr_scale"):  # in the basis of each side's own task spaces
                li = int(k.split(".")[1])
                for j in range(2):
                    got = _scale_update(p[t, j], state.mvars["tr_space"][li][t, j])
                    ref_m = _scale_update(want[k][t, j], torch.from_numpy(mvars["tr_space"][li][t, j]))
                    np.testing.assert_allclose(got, ref_m, atol=PARAM_TOL,
                                               err_msg=f"task {t} {k} slot {j}")
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[k].detach().numpy(),
                                       atol=PARAM_TOL, err_msg=f"task {t} {k}")
        load_gradproj_state(pm, state, params, mvars, host)

    port.epoch_hook = resync
    if name == "API":
        port_before = pm.before_task

        def feed_slabs(state, task_idx, task_data):
            state = port_before(state, task_idx, task_data)
            slabs, counts, retain = jax_slabs[task_idx]
            np.testing.assert_array_equal(pm._ws_counts, counts)
            if task_idx == 0:
                return state
            np.testing.assert_allclose(pm.per_layer_retain, retain, atol=1e-4)
            assert counts.sum() > 0, "no layer expanded"
            bb = state.params["backbone"]
            for li in range(5):
                got = getattr(bb, f"ws{li}").detach().numpy()
                sign = np.sign(np.sum(got * slabs[f"ws{li}"], axis=1, keepdims=True))
                np.testing.assert_allclose(got * np.where(sign == 0, 1, sign), slabs[f"ws{li}"],
                                           atol=1e-4, err_msg=f"ws{li}")
                with torch.no_grad():
                    getattr(bb, f"ws{li}").copy_(torch.from_numpy(slabs[f"ws{li}"]))
            return state
        pm.before_task = feed_slabs
    port_res = port.train_loop()

    assert [len(x) for x in port_losses] == [3, 3] and len(jax_epochs) == 2
    for ep, ((ref, _, _, _), got) in enumerate(zip(jax_epochs, port_losses)):
        np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    assert port_res["acc_table"][1].min() > 0
    mv, jmv = port.state.mvars, _numpy(jax_tr.state.mvars)
    if name == "DMNSP":
        assert mv["basis_n"] == [int(n) for n in jmv["basis_n"]]
        np.testing.assert_allclose(mv["lam"].numpy(), jmv["lam"], rtol=1e-4)
        np.testing.assert_allclose(mv["P"].numpy(), jmv["P"], atol=1e-4)
    else:
        assert [u.shape[1] for u in pm._feature_list] == [u.shape[1] for u in jm._feature_list]
        for a, b in zip(mv["proj"], jmv["proj"]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4)
    if name == "API":
        assert pm._project_type == jm._project_type
        np.testing.assert_array_equal(pm._ws_counts, jm._ws_counts)
