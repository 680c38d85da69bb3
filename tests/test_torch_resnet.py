"""The port's ResNet family against the JAX package at small widths and
depth, float32: the weights converted from the flax tree, train-mode and
eval-mode features, the gradient of a feature projection, the BatchNorm
running statistics after two train steps (flax's momentum and biased
variance), ``last_relu=False``, the ImageNet stem, and the kaiming init.
The Bottleneck ResNet (resnet50's blocks), BiC's pre-activation ResNet, CBAM
(both stems: flax's ``SAME`` padding) and TinyCNN (even and odd inputs) the
same way, every parameter, gradient and running statistic compared through
the converter; their registrations at full size."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.models import cbam as JC  # noqa: E402
from libcontinual_tpu.models import resnet as JR  # noqa: E402
from libcontinual_tpu_torch.convert import load_resnet  # noqa: E402
from libcontinual_tpu_torch.models import cbam as C  # noqa: E402
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
#: the backbones of the classic methods
NEW_CASES = {
    "bottleneck_cifar": (lambda: JR.ResNet(stage_sizes=[1, 2], block=JR.Bottleneck,
                                           num_filters=8, cifar_stem=True, dtype=jnp.float32),
                         lambda: R.ResNet([1, 2], 8, cifar_stem=True, dtype=torch.float32,
                                          block=R.Bottleneck), 8),
    "bottleneck_imagenet": (lambda: JR.ResNet(stage_sizes=[1, 1], block=JR.Bottleneck,
                                              num_filters=8, dtype=jnp.float32),
                            lambda: R.ResNet([1, 1], 8, dtype=torch.float32,
                                             block=R.Bottleneck), 16),
    "cifar_resnet32_V2": (lambda: JR.PreActCifarResNet(depth=32, dtype=jnp.float32),
                          lambda: R.PreActCifarResNet(32, dtype=torch.float32), 8),
    "cbam_cifar": (lambda: JC.CBAMResNet(stage_sizes=[1, 1], num_filters=32),
                   lambda: C.CBAMResNet([1, 1], 32), 8),
    "cbam_imagenet": (lambda: JC.CBAMResNet(stage_sizes=[1, 1], num_filters=32,
                                            cifar_stem=False),
                      lambda: C.CBAMResNet([1, 1], 32, cifar_stem=False), 16),
    "tiny_cnn": (lambda: JR.TinyCNN(), lambda: R.TinyCNN(), 8),
    "tiny_cnn_odd": (lambda: JR.TinyCNN(), lambda: R.TinyCNN(), 7),
}
CASES.update(NEW_CASES)
#: relative float32 tolerance where features are large: the pre-activation
#: net's residual sums grow to ~50 over its 15 blocks at init (eval mode
#: normalises with the initial statistics, mean 0 and variance 1)
FEATURE_RTOL = {"cifar_resnet32_V2": 1e-5}


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
    rtol = FEATURE_RTOL.get(name, 0)
    np.testing.assert_allclose(ptrain.numpy(), np.asarray(jtrain["features"]), atol=TOL, rtol=rtol)
    np.testing.assert_allclose(peval.numpy(), np.asarray(jeval["features"]), atol=TOL, rtol=rtol)
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


def _as_port(pm, p, stats):
    """A copy of ``pm`` holding a flax-shaped tree: its parameters ``p`` and
    its running statistics ``stats``, through the converter."""
    import copy

    ref = copy.deepcopy(pm)
    load_resnet(ref, p, stats)
    return ref


@pytest.mark.parametrize("name", list(NEW_CASES))
def test_new_backbones_statistics_after_two_train_steps(name):
    jm, variables, pm, hw = _pair(name)
    for step in range(2):
        x = _batch(hw, 10 + step) * (1.0 + step)
        _, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": new["batch_stats"]}
        pm(torch.from_numpy(x), train=True)
    ref = _as_port(pm, _numpy(variables["params"]), _numpy(variables["batch_stats"]))
    got = dict(pm.named_buffers())
    assert got and len(got) == len(jax.tree_util.tree_leaves(variables["batch_stats"]))
    for k, v in ref.named_buffers():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(NEW_CASES))
def test_new_backbones_gradients_match(name):
    jm, variables, pm, hw = _pair(name)
    x = _batch(hw, 3)
    feat = jm.apply(variables, jnp.asarray(x), train=False)["features"].shape[-1]
    u = np.random.RandomState(4).randn(feat).astype(np.float32)

    def f(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out["features"] @ jnp.asarray(u))

    jg = _numpy(jax.grad(f)(variables["params"]))
    (pm(torch.from_numpy(x), train=True)["features"] @ torch.from_numpy(u)).sum().backward()
    ref = _as_port(pm, jg, _numpy(variables["batch_stats"]))
    for (k, p), (_, g) in zip(pm.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(), atol=GRAD_TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(NEW_CASES))
def test_new_backbones_conversion_copies_every_weight(name):
    """Every flax leaf filled with its own index: each port parameter and
    running statistic holds exactly one index, and every index lands."""
    _, variables, pm, _ = _pair(name)
    leaves = {}

    def tag(tree):
        def one(a):
            leaves[len(leaves) + 1] = a.shape
            return np.full(a.shape, float(len(leaves)), np.float32)
        return jax.tree_util.tree_map(one, _numpy(tree))

    p, stats = tag(variables["params"]), tag(variables["batch_stats"])
    load_resnet(pm, p, stats)
    got = []
    for k, t in list(pm.named_parameters()) + list(pm.named_buffers()):
        vals = torch.unique(t.detach())
        assert len(vals) == 1, k
        got.append(int(vals[0]))
        assert t.numel() == math.prod(leaves[got[-1]]), k
    assert sorted(got) == list(range(1, len(leaves) + 1))


@pytest.mark.parametrize("name,feat", [("resnet50", 2048), ("cifar_resnet32_V2", 64),
                                       ("cifar_resnet32_bic", 64), ("resnet18_cbam", 512),
                                       ("tiny_cnn", 32)])
def test_new_registrations_and_feature_dims(name, feat):
    """The registered backbones build (no longer raise), with the JAX module's
    parameter count and feature width; CBAM runs in f32 whatever the dtype."""
    kw = {"args": {"dataset": "cifar100"}}
    m = BACKBONES.get(name)(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                            **kw)
    jm = __import__("libcontinual_tpu.registry", fromlist=["BACKBONES"]).BACKBONES.get(name)(
        dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 3)),
                                            train=False))
    n_jax = sum(math.prod(a.shape) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(t.numel() for t in m.parameters()) == n_jax
    assert R.FEATURE_DIMS[name] == JR.FEATURE_DIMS[name] == feat
    out = m(torch.zeros(2, 8, 8, 3), train=False)["features"]
    assert out.shape == (2, feat) and out.dtype == torch.float32
    if name == "resnet18_cbam":
        assert m.dtype == torch.float32 and m.cifar_stem
    if name == "resnet50":
        assert m.blocks[0].downsample is not None and m.blocks[1].downsample is None


@pytest.mark.parametrize("size,stride,kernel,pads", [(8, 2, 3, (0, 1)), (7, 2, 3, (1, 1)),
                                                     (16, 2, 7, (2, 3)), (8, 1, 3, (1, 1)),
                                                     (8, 1, 7, (3, 3)), (8, 2, 1, (0, 0))])
def test_same_padding_is_flax(size, stride, kernel, pads):
    assert R.same_pad(size, kernel, stride) == pads


def test_lecun_init_is_flax_default():
    w = torch.empty(64, 128, 3, 3)
    R.lecun_normal_(w, torch.Generator().manual_seed(0))
    std = math.sqrt(1.0 / (128 * 9))
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978


def test_kaiming_init_is_flax_he_normal():
    w = torch.empty(64, 128, 3, 3)
    R.kaiming_normal_(w, torch.Generator().manual_seed(0))
    std = math.sqrt(2.0 / (128 * 9))
    assert abs(float(w.std()) / std - 1.0) < 0.02  # the variance is 2 / fan_in
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978  # truncated at 2 deviations
