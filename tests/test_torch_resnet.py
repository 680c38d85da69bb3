"""The port's ResNet family against the JAX package at small widths and
depth, float32: the weights converted from the flax tree, train-mode and
eval-mode features, the gradient of a feature projection, the BatchNorm
running statistics after two train steps (flax's momentum and biased
variance), ``last_relu=False``, the ImageNet stem, and the kaiming init."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.models import resnet as JR  # noqa: E402
from libcontinual_tpu_torch.convert import load_resnet  # noqa: E402
from libcontinual_tpu_torch.models import resnet as R  # noqa: E402
from libcontinual_tpu_torch.registry import BACKBONES  # noqa: E402

#: float32 through a few conv/BN layers: sums in another order
TOL = 2e-5
#: the gradient through the BatchNorm statistics
GRAD_TOL = 1e-4

CASES = {
    "resnet_cifar": (lambda: JR.ResNet(stage_sizes=[1, 1], num_filters=8, cifar_stem=True,
                                       dtype=jnp.float32),
                     lambda: R.ResNet([1, 1], 8, cifar_stem=True, dtype=torch.float32), 8),
    "resnet_imagenet": (lambda: JR.ResNet(stage_sizes=[1, 1], num_filters=8, dtype=jnp.float32),
                        lambda: R.ResNet([1, 1], 8, dtype=torch.float32), 16),
    "resnet_last_relu_off": (lambda: JR.ResNet(stage_sizes=[1, 2], num_filters=8,
                                               cifar_stem=True, last_relu=False,
                                               dtype=jnp.float32),
                             lambda: R.ResNet([1, 2], 8, cifar_stem=True, last_relu=False,
                                              dtype=torch.float32), 8),
    "cifar_resnet20": (lambda: JR.CifarResNet(depth=20, dtype=jnp.float32),
                       lambda: R.CifarResNet(20, dtype=torch.float32), 8),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, seed=0):
    """(flax module, its variables, the port module with those weights, hw)."""
    make_jax, make_port, hw = CASES[name]
    jm = make_jax()
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, hw, hw, 3)), train=False)
    pm = make_port()
    load_resnet(pm, _numpy(variables["params"]), _numpy(variables["batch_stats"]))
    return jm, variables, pm, hw


def _batch(hw, seed):
    return np.random.RandomState(seed).randn(4, hw, hw, 3).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_features_match_in_train_and_eval_mode(name):
    jm, variables, pm, hw = _pair(name)
    x = _batch(hw, 1)
    jtrain, _ = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    jeval = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ptrain = pm(torch.from_numpy(x), train=True, update_stats=False)["features"]
        peval = pm(torch.from_numpy(x), train=False)["features"]
    np.testing.assert_allclose(ptrain.numpy(), np.asarray(jtrain["features"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(peval.numpy(), np.asarray(jeval["features"]), atol=TOL, rtol=0)
    if name == "resnet_last_relu_off":  # the last block keeps negative values
        assert (ptrain < 0).any()


@pytest.mark.parametrize("name", ["resnet_cifar", "cifar_resnet20"])
def test_running_statistics_after_two_train_steps(name):
    jm, variables, pm, hw = _pair(name)
    for step in range(2):
        x = _batch(hw, 10 + step) * (1.0 + step)  # a second batch of another scale
        _, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": new["batch_stats"]}
        pm(torch.from_numpy(x), train=True)
    stats = _numpy(variables["batch_stats"])
    for got, ref in ((pm.bn_stem, stats["bn_stem"]), (pm.blocks[1].bn1, stats["BasicBlock_1"]["BatchNorm_1"])):
        np.testing.assert_allclose(got.running_mean.numpy(), ref["mean"], atol=TOL, rtol=0)
        np.testing.assert_allclose(got.running_var.numpy(), ref["var"], atol=TOL, rtol=1e-5)
    # torch's F.batch_norm would have folded in the unbiased variance
    x = torch.from_numpy(_batch(hw, 11) * 2.0).permute(0, 3, 1, 2)
    conv = pm.conv_stem(x)
    n = conv.numel() // conv.shape[1]
    biased = conv.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(biased * n / (n - 1), conv.var(dim=(0, 2, 3))) and n > 1


def test_gradients_match():
    jm, variables, pm, hw = _pair("resnet_cifar")
    x = _batch(hw, 3)
    u = np.random.RandomState(4).randn(16).astype(np.float32)

    def f(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out["features"] @ jnp.asarray(u))

    jg = _numpy(jax.grad(f)(variables["params"]))
    (pm(torch.from_numpy(x), train=True)["features"] @ torch.from_numpy(u)).sum().backward()
    np.testing.assert_allclose(pm.conv_stem.weight.grad.permute(2, 3, 1, 0).numpy(),
                               jg["conv_stem"]["kernel"], atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(pm.blocks[1].downsample_bn.weight.grad.numpy(),
                               jg["BasicBlock_1"]["downsample_bn"]["scale"], atol=GRAD_TOL, rtol=0)


def test_conversion_copies_every_weight():
    _, variables, pm, _ = _pair("resnet_cifar", seed=5)
    p = _numpy(variables["params"])
    np.testing.assert_array_equal(pm.blocks[1].conv1.weight.detach().numpy(),
                                  p["BasicBlock_1"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(pm.blocks[1].downsample.weight.detach().numpy(),
                                  p["BasicBlock_1"]["downsample"]["kernel"].transpose(3, 2, 0, 1))
    assert pm.blocks[0].downsample is None and "downsample" not in p["BasicBlock_0"]
    n_port = sum(t.numel() for t in pm.parameters())
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(p))
    assert n_port == n_jax


@pytest.mark.parametrize("name,feat,blocks", [("resnet18", 512, 8), ("resnet34", 512, 16),
                                              ("resnet18_AML", 160, 8), ("cifar_resnet32", 64, 15),
                                              ("resnet32_V2", 64, 15)])
def test_registrations_and_feature_dims(name, feat, blocks):
    m = BACKBONES.get(name)(dtype=torch.float32, args={"dataset": "cifar100"})
    assert len(m.blocks) == blocks and m.blocks[-1].bn1.weight.shape[0] == feat
    assert R.FEATURE_DIMS[name] == JR.FEATURE_DIMS[name] == feat
    assert m.cifar_stem and m.conv_stem.weight.shape[-1] == 3
    if name == "resnet32_V2":
        assert not m.blocks[-1].last_relu and m.blocks[-2].last_relu


@pytest.mark.parametrize("dataset,cifar_stem", [("cifar100", True), ("synthetic", False)])
def test_config_dataset_picks_the_stem_as_in_jax(dataset, cifar_stem):
    """The config's dataset reaches the factory: a CIFAR dataset gives the
    3x3 stride-1 stem on both sides, any other the 7x7 stride-2 one."""
    from libcontinual_tpu.models import get_backbone as jax_get_backbone
    from libcontinual_tpu_torch.models import get_backbone

    cfg = {"dataset": dataset, "backbone": {"name": "resnet18", "kwargs": {}}}
    m = get_backbone(cfg)
    assert m.cifar_stem == jax_get_backbone(cfg).cifar_stem == cifar_stem
    assert m.conv_stem.weight.shape[-1] == (3 if cifar_stem else 7)


@pytest.mark.parametrize("name", ["resnet50", "cifar_resnet32_V2", "resnet18_cbam", "tiny_cnn"])
def test_unported_backbones_raise(name):
    with pytest.raises(NotImplementedError, match="Queue 1"):
        BACKBONES.get(name)(dtype=torch.float32)


def test_kaiming_init_is_flax_he_normal():
    w = torch.empty(64, 128, 3, 3)
    R.kaiming_normal_(w, torch.Generator().manual_seed(0))
    std = math.sqrt(2.0 / (128 * 9))
    assert abs(float(w.std()) / std - 1.0) < 0.02  # the variance is 2 / fan_in
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978  # truncated at 2 deviations
