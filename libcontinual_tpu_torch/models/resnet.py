"""The ResNet family (``libcontinual_tpu/models/resnet.py``).

  * ``ResNet``: torchvision-style resnet18/34 of ``BasicBlock``s, with the
    CIFAR stem (3x3 stride-1 conv, no max-pool) for CIFAR datasets and the
    ImageNet stem (7x7 stride-2 conv, 3x3 stride-2 max-pool) otherwise;
  * ``CifarResNet``: the depth-(6n+2) CIFAR architecture behind
    cifar_resnet20/32, 16 filters, 64-d features;
  * ``last_relu=False`` drops the last block's final ReLU (LUCIR's
    modified ResNet); ``num_filters`` sets the width (resnet18_AML: 20).

The JAX package's semantics, kept here:
  * the activations come in NHWC and the features are the spatial mean of the
    last stage, ``(B, feat_dim)`` f32. Inside, the tensors are NCHW views with
    NHWC memory (``channels_last``), so cuDNN runs its NHWC kernels;
  * every convolution is ``F.conv2d`` (cuDNN on the card) with the input and
    the weights cast to the compute dtype and symmetric ``(k - 1) // 2``
    padding (``_torch_pad``), bias-free, weights f32 and drawn from flax's
    ``kaiming_normal`` (a normal truncated at two deviations over the
    fan-in, variance ``2 / fan_in``);
  * :class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``:
    statistics in f32, the variance as ``E[x^2] - E[x]^2`` clipped at 0 and
    **biased** (also in the running average, where ``F.batch_norm`` would
    take the unbiased one), the running statistics f32 and updated as
    ``0.9 * running + 0.1 * batch``, the output in the compute dtype.

``forward(x, train, update_stats)``: ``train`` normalises with the batch's
statistics and, with ``update_stats``, folds them into the running ones (a
distillation teacher runs in train mode without updating); eval mode
normalises with the running statistics.

Not ported yet: ``Bottleneck`` / resnet50, the pre-activation
``PreActCifarResNet`` (BiC), ``resnet18_cbam`` and ``TinyCNN`` (Queue 1 item
6, the classic ResNet methods), and the ``LIBCONTINUAL_STEM=matmul`` stem, a
TPU experiment. Their registrations raise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.registry import BACKBONES


def _torch_pad(kernel: int) -> int:
    """Symmetric ``(k - 1) // 2`` padding on each side: torch's
    ``padding=k//2`` convention (flax's ``SAME`` pads 0 before and 1 after
    under stride 2)."""
    return (kernel - 1) // 2


def kaiming_normal_(w: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    """flax ``kaiming_normal`` (``he_normal``): a normal truncated at two
    deviations, rescaled so the variance is ``2 / fan_in``; fan-in is
    ``C * kh * kw`` of an OIHW weight."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Conv(nn.Module):
    """flax ``Conv(use_bias=False, dtype=...)`` with torch padding: an OIHW
    f32 weight, applied in the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, _torch_pad(kernel), dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        kaiming_normal_(self.weight, generator)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride,
                        self.padding)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=...)`` over the
    channels of an NCHW tensor (see the module docstring)."""

    def __init__(self, channels: int, dtype=torch.bfloat16, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1, last_relu: bool = True,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.last_relu = last_relu
        self.conv0 = Conv(cin, filters, 3, stride, dtype, generator)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, 1, dtype, generator)
        self.bn1 = BatchNorm(filters, dtype)
        # the JAX block adds a projection wherever the shapes differ
        self.downsample = self.downsample_bn = None
        if stride != 1 or cin != filters:
            self.downsample = Conv(cin, filters, 1, stride, dtype, generator)
            self.downsample_bn = BatchNorm(filters, dtype)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        y = F.relu(self.bn0(self.conv0(x), train, update_stats))
        y = self.bn1(self.conv1(y), train, update_stats)
        residual = x
        if self.downsample is not None:
            residual = self.downsample_bn(self.downsample(x), train, update_stats)
        y = y + residual
        return F.relu(y) if self.last_relu else y


def _stage_blocks(stage_sizes, num_filters, cin, last_relu, dtype, generator):
    """The blocks of every stage in order; stage i > 0 starts with stride 2,
    and only the very last block may drop its ReLU."""
    blocks = []
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            is_last = i == len(stage_sizes) - 1 and j == n_blocks - 1
            filters = num_filters * 2 ** i
            blocks.append(BasicBlock(cin, filters, 2 if i > 0 and j == 0 else 1,
                                     last_relu or not is_last, dtype, generator))
            cin = filters
    return nn.ModuleList(blocks)


class ResNet(nn.Module):
    """torchvision-style ResNet of ``BasicBlock``s with an optional CIFAR stem."""

    def __init__(self, stage_sizes: Sequence[int], num_filters: int = 64,
                 cifar_stem: bool = False, last_relu: bool = True, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.cifar_stem = dtype, cifar_stem
        self.conv_stem = Conv(3, num_filters, 3 if cifar_stem else 7, 1 if cifar_stem else 2,
                              dtype, generator)
        self.bn_stem = BatchNorm(num_filters, dtype)
        self.blocks = _stage_blocks(stage_sizes, num_filters, num_filters, last_relu, dtype,
                                    generator)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        x = x.permute(0, 3, 1, 2)  # NHWC -> an NCHW view of NHWC memory
        x = F.relu(self.bn_stem(self.conv_stem(x), train, update_stats))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks:
            x = blk(x, train, update_stats)
        return {"features": x.mean(dim=(2, 3)).float()}


def CifarResNet(depth: int = 32, num_filters: int = 16, last_relu: bool = True,
                dtype=torch.bfloat16, generator: Optional[torch.Generator] = None) -> ResNet:
    """Depth-(6n+2) CIFAR ResNet (cifar_resnet20/32), 64-d features: the JAX
    module's layers and names are a :class:`ResNet` with the CIFAR stem and
    three stages of n blocks."""
    n = (depth - 2) // 6
    return ResNet([n] * 3, num_filters, cifar_stem=True, last_relu=last_relu, dtype=dtype,
                  generator=generator)


def _is_cifar(kwargs) -> bool:
    args = kwargs.get("args") or {}
    return "cifar" in str(args.get("dataset", kwargs.get("dataset", "")))


def _resnet(stage_sizes, kwargs, **over):
    return ResNet(stage_sizes, cifar_stem=_is_cifar(kwargs),
                  dtype=kwargs.get("dtype", torch.bfloat16),
                  generator=kwargs.get("generator"), **over)


def _cifar_resnet(depth, kwargs, **over):
    return CifarResNet(depth, dtype=kwargs.get("dtype", torch.bfloat16),
                       generator=kwargs.get("generator"), **over)


@BACKBONES.register("resnet18")
def resnet18(**kwargs):
    return _resnet([2, 2, 2, 2], kwargs)


@BACKBONES.register("resnet34")
def resnet34(**kwargs):
    return _resnet([3, 4, 6, 3], kwargs)


@BACKBONES.register("resnet18_lucir")
def resnet18_lucir(**kwargs):
    """LUCIR's modified resnet: no ReLU after the last block."""
    return _resnet([2, 2, 2, 2], kwargs, last_relu=False)


@BACKBONES.register("resnet18_AML", aliases=("resnet18_aml",))
def resnet18_aml(**kwargs):
    """The slim 20-filter resnet18 of ER-ACE / ER-AML, always with the CIFAR
    stem; 160-d features."""
    return _resnet([2, 2, 2, 2], dict(kwargs, args={"dataset": "cifar"}), num_filters=20)


@BACKBONES.register("cifar_resnet20")
def cifar_resnet20(**kwargs):
    return _cifar_resnet(20, kwargs)


@BACKBONES.register("cifar_resnet32")
def cifar_resnet32(**kwargs):
    return _cifar_resnet(32, kwargs)


@BACKBONES.register("cifar_resnet32_lucir", aliases=("resnet32_V2",))
def cifar_resnet32_lucir(**kwargs):
    """resnet32_V2: LUCIR's modified CIFAR ResNet, no ReLU after the last block."""
    return _cifar_resnet(32, kwargs, last_relu=False)


def _not_ported(name: str, what: str):
    def factory(**kwargs):
        raise NotImplementedError(
            f"backbone '{name}' ({what}) is not in the PyTorch port yet "
            "(ROADMAP.md Queue 1 item 6)")
    return factory


BACKBONES.register("resnet50")(_not_ported("resnet50", "Bottleneck blocks"))
BACKBONES.register("cifar_resnet32_V2", aliases=("cifar_resnet32_bic",))(
    _not_ported("cifar_resnet32_V2", "the pre-activation ResNet of BiC"))
BACKBONES.register("resnet18_cbam")(_not_ported("resnet18_cbam", "CBAM attention"))
BACKBONES.register("tiny_cnn")(_not_ported("tiny_cnn", "the test-only CNN"))


#: feature width of each registered ResNet name
FEATURE_DIMS = {
    "resnet18": 512,
    "resnet34": 512,
    "resnet50": 2048,
    "resnet18_lucir": 512,
    "resnet18_AML": 160,
    "resnet18_aml": 160,
    "cifar_resnet20": 64,
    "cifar_resnet32": 64,
    "cifar_resnet32_V2": 64,
    "cifar_resnet32_bic": 64,
    "cifar_resnet32_lucir": 64,
    "resnet32_V2": 64,
    "resnet18_cbam": 512,
    "tiny_cnn": 32,
}
