"""The port's trainer against the JAX trainer for the CLIP methods: 2-task
micro-runs of ``configs/moe_adapter-synth.yaml`` and
``configs/rapf-synth.yaml`` on ``clip_tiny_test`` in float32 (cut to 1 epoch
of 16 images a class), from the same initial weights, with the same batch
order, compared step by step and on the final acc table.

The two frameworks cannot draw the same random numbers, so:
  * MoE-Adapter4CL's gate noise and expert dropout are off on both sides
    (the JAX method's forward gets no rng, the port's no generator);
  * RAPF's replay and edge noise are the JAX run's own draws, rebuilt from
    its state's key chain and fed to the port's loss."""

from __future__ import annotations

import copy
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.core.trainer import Trainer as JaxTrainer  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.convert import clip_state_from_flax  # noqa: E402
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: per-step losses, f32 on the CPU: the two frameworks sum in other orders,
#: and the drift grows over the run's Adam steps
LOSS_TOL = 1e-4
CONFIGS = {"MOE_ADAPTER4CL": "moe_adapter-synth.yaml", "RAPF": "rapf-synth.yaml"}
OVERRIDES = {
    "dtype": "float32", "epoch": 1, "per_class": 16, "testing_times": 1,
    "mesh": {"data": 1, "model": 1},
    # eps 1e-6: see LR, ADAM_EPS in test_torch_clip_methods.py
    "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001, "eps": 1e-6}},
}


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.array, jax.device_get(t))


def _jax_noise_chain(method, rng):
    """The JAX run's RAPF draws, one pair per train step, from its state's
    key chain: ``rng, _, loss_rng = split(rng, 3)`` a step, then
    ``split(loss_rng)`` into the replay and edge keys."""
    keys = [rng]

    def draw(state):
        keys[0], _, loss_rng = jax.random.split(keys[0], 3)
        k_replay, k_edge = jax.random.split(loss_rng)
        shapes = ((method.replay_cpb, method.replay_per_cls, method.embed_dim),
                  (method.hard_cap, method.edge_per_pair, method.embed_dim))
        return tuple(torch.from_numpy(np.array(jax.random.normal(k, s)))
                     for k, s in zip((k_replay, k_edge), shapes))

    return draw


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clip_two_task_trainer_matches_jax(name):
    path = os.path.join(REPO, "configs", CONFIGS[name])
    jax_tr = JaxTrainer(JaxConfig(path, overrides=copy.deepcopy(OVERRIDES)).get_config_dict())
    port = Trainer(Config(path, overrides=copy.deepcopy(OVERRIDES)).get_config_dict(),
                   device="cpu")
    assert port.method.num_class == jax_tr.method.num_class == 8
    port.state = clip_state_from_flax(port.method, _numpy_tree(jax_tr.state.params),
                                      _numpy_tree(jax_tr.state.mvars), seed=7)
    if name == "MOE_ADAPTER4CL":
        jm = jax_tr.method
        apply = jm._apply
        jm._apply = lambda params, mvars, images, tokens, train, rng=None: apply(
            params, mvars, images, tokens, train, None)
        port.method.moe_generator = lambda state: None
        frozen = {n: p.detach().clone() for n, p in port.state.params.named_parameters()
                  if not p.requires_grad}
    else:
        # the JAX trainer donates its state's buffers: copy the key first
        port.method.draw_noise = _jax_noise_chain(port.method, np.array(jax_tr.state.rng))
        frozen = {k: v.clone() for k, v in port.state.mvars["frozen"].state_dict().items()}

    jax_losses, port_losses = [], []
    jax_tr.epoch_hook = lambda t, e, s, losses: jax_losses.append(np.asarray(losses))
    port.epoch_hook = lambda t, e, s, losses: port_losses.append(np.asarray(losses))
    jax_res = jax_tr.train_loop()
    port_res = port.train_loop()

    assert len(port_losses) == len(jax_losses) == 2  # 2 tasks x 1 epoch
    for ep, (a, b) in enumerate(zip(jax_losses, port_losses)):
        assert len(a) == len(b) == 4
        np.testing.assert_allclose(b, a, rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=f"epoch {ep}")
    np.testing.assert_array_equal(port_res["acc_table"], jax_res["acc_table"])
    if name == "MOE_ADAPTER4CL":
        for n, p in port.state.params.named_parameters():
            if n in frozen:
                assert torch.equal(p, frozen[n]), n
        return
    # RAPF: the state its after_task left after task 1
    mv, jmv = port.state.mvars, jax_tr.state.mvars
    for k, v in mv["frozen"].state_dict().items():
        assert torch.equal(v, frozen[k]), k
    for key in ("text_feats", "cls_mean", "cls_chol", "cls_valid"):
        np.testing.assert_allclose(mv[key].numpy(), np.asarray(jmv[key]), atol=1e-4, rtol=1e-4,
                                   err_msg=key)
    for key in ("replay_order", "hard_old", "hard_new", "hard_valid"):
        np.testing.assert_array_equal(mv[key].numpy(), np.asarray(jmv[key]), err_msg=key)
    np.testing.assert_allclose(port.state.params["adapter"]["kernel"].detach().numpy(),
                               np.asarray(jax_tr.state.params["adapter"]["kernel"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(mv["old_adapter"]["kernel"].numpy(),
                               np.asarray(jmv["old_adapter"]["kernel"]), atol=1e-4, rtol=1e-4)
