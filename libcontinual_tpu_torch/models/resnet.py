"""The ResNet family (``libcontinual_tpu/models/resnet.py``).

  * ``ResNet``: torchvision-style resnet18/34 of ``BasicBlock``s and resnet50
    of ``Bottleneck``s (expansion 4), with the CIFAR stem (3x3 stride-1 conv,
    no max-pool) for CIFAR datasets and the ImageNet stem (7x7 stride-2 conv,
    3x3 stride-2 max-pool) otherwise;
  * ``CifarResNet``: the depth-(6n+2) CIFAR architecture behind
    cifar_resnet20/32, 16 filters, 64-d features;
  * ``PreActCifarResNet``: BiC's pre-activation CIFAR ResNet
    (``cifar_resnet32_V2``): a bare conv stem, blocks of bn-relu-conv twice
    with a conv-only shortcut from the raw input, and one final bn + relu;
  * ``TinyCNN``: two stride-2 convolutions, the test-only net (flax's
    ``SAME`` padding and ``lecun_normal`` init, as the JAX module has them);
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

``resnet18_cbam`` is in :mod:`~libcontinual_tpu_torch.models.cbam`. Not
ported: the ``LIBCONTINUAL_STEM=matmul`` stem, a TPU experiment.
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


def _truncated_normal_(w: torch.Tensor, scale: float, gen: Optional[torch.Generator]) -> None:
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``: a
    normal truncated at two deviations, rescaled so the variance is
    ``scale / fan_in``; fan-in is the product of every axis but the first
    (``C * kh * kw`` of an OIHW weight, ``in`` of an ``(out, in)`` one)."""
    fan_in = math.prod(w.shape[1:])
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def kaiming_normal_(w: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    """flax ``kaiming_normal`` (``he_normal``): variance ``2 / fan_in``."""
    _truncated_normal_(w, 2.0, gen)


def lecun_normal_(w: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    """flax ``lecun_normal``, the default of ``nn.Conv`` and ``nn.Dense``:
    variance ``1 / fan_in``."""
    _truncated_normal_(w, 1.0, gen)


def same_pad(size: int, kernel: int, stride: int):
    """flax's ``SAME`` padding of one axis, (before, after): the output has
    ``ceil(size / stride)`` positions and the odd pixel goes after (a
    stride-2 3x3 conv on an even input pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``Conv(use_bias=False, dtype=...)``: an OIHW f32 weight, applied
    in the compute dtype. ``same=False`` pads with torch's symmetric
    ``(k - 1) // 2`` (the ResNets), ``same=True`` with flax's ``SAME`` (CBAM,
    TinyCNN); ``init`` draws the weight (``kaiming_normal_`` by default)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None,
                 same: bool = False, init=kaiming_normal_):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, _torch_pad(kernel), dtype
        self.same = same
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        init(self.weight, generator)

    def forward(self, x):
        w = self.weight.to(self.dtype)
        if not self.same:
            return F.conv2d(x.to(self.dtype), w, None, self.stride, self.padding)
        k = self.weight.shape[-1]
        (top, bottom), (left, right) = (same_pad(n, k, self.stride) for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x.to(self.dtype), w, None, self.stride, (top, left))
        return F.conv2d(F.pad(x.to(self.dtype), (left, right, top, bottom)), w, None,
                        self.stride)


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
    expansion = 1

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


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (the stride), 1x1 expand by 4, with a 1x1 projection
    and its BatchNorm wherever the shape changes (already in stage 1's first
    block, 64 -> 256)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, last_relu: bool = True,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.last_relu = last_relu
        out = filters * self.expansion
        self.conv0 = Conv(cin, filters, 1, 1, dtype, generator)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, stride, dtype, generator)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, out, 1, 1, dtype, generator)
        self.bn2 = BatchNorm(out, dtype)
        self.downsample = self.downsample_bn = None
        if stride != 1 or cin != out:
            self.downsample = Conv(cin, out, 1, stride, dtype, generator)
            self.downsample_bn = BatchNorm(out, dtype)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        y = F.relu(self.bn0(self.conv0(x), train, update_stats))
        y = F.relu(self.bn1(self.conv1(y), train, update_stats))
        y = self.bn2(self.conv2(y), train, update_stats)
        residual = x
        if self.downsample is not None:
            residual = self.downsample_bn(self.downsample(x), train, update_stats)
        y = y + residual
        return F.relu(y) if self.last_relu else y


def _stage_blocks(stage_sizes, num_filters, cin, last_relu, dtype, generator,
                  block=BasicBlock):
    """The blocks of every stage in order; stage i > 0 starts with stride 2,
    and only the very last block may drop its ReLU."""
    blocks = []
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            is_last = i == len(stage_sizes) - 1 and j == n_blocks - 1
            filters = num_filters * 2 ** i
            blocks.append(block(cin, filters, 2 if i > 0 and j == 0 else 1,
                                last_relu or not is_last, dtype, generator))
            cin = filters * block.expansion
    return nn.ModuleList(blocks)


class ResNet(nn.Module):
    """torchvision-style ResNet of ``BasicBlock``s or ``Bottleneck``s with an
    optional CIFAR stem."""

    def __init__(self, stage_sizes: Sequence[int], num_filters: int = 64,
                 cifar_stem: bool = False, last_relu: bool = True, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None, block=BasicBlock):
        super().__init__()
        self.dtype, self.cifar_stem = dtype, cifar_stem
        self.conv_stem = Conv(3, num_filters, 3 if cifar_stem else 7, 1 if cifar_stem else 2,
                              dtype, generator)
        self.bn_stem = BatchNorm(num_filters, dtype)
        self.blocks = _stage_blocks(stage_sizes, num_filters, num_filters, last_relu, dtype,
                                    generator, block)

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


class PreActBasicBlock(nn.Module):
    """bn-relu-conv twice; the shortcut is the raw input, or a bare 1x1
    conv of it wherever the shape changes."""

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.bn0 = BatchNorm(cin, dtype)
        self.conv0 = Conv(cin, filters, 3, stride, dtype, generator)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, 1, dtype, generator)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = Conv(cin, filters, 1, stride, dtype, generator)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        y = self.conv0(F.relu(self.bn0(x, train, update_stats)))
        y = self.conv1(F.relu(self.bn1(y, train, update_stats)))
        residual = x if self.downsample is None else self.downsample(x)
        return y + residual


class PreActCifarResNet(nn.Module):
    """BiC's pre-activation CIFAR ResNet, depth 6n+2, 64-d features."""

    cifar_stem = True

    def __init__(self, depth: int = 32, num_filters: int = 16, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = (depth - 2) // 6
        self.dtype = dtype
        self.conv_stem = Conv(3, num_filters, 3, 1, dtype, generator)
        blocks, cin = [], num_filters
        for i in range(3):
            for j in range(n):
                filters = num_filters * 2 ** i
                blocks.append(PreActBasicBlock(cin, filters, 2 if i > 0 and j == 0 else 1,
                                               dtype, generator))
                cin = filters
        self.blocks = nn.ModuleList(blocks)
        self.bn_final = BatchNorm(cin, dtype)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        x = self.conv_stem(x.permute(0, 3, 1, 2))
        for blk in self.blocks:
            x = blk(x, train, update_stats)
        x = F.relu(self.bn_final(x, train, update_stats))
        return {"features": x.mean(dim=(2, 3)).float()}


class TinyCNN(nn.Module):
    """Two stride-2 3x3 convolutions (16 and 32 filters) with BatchNorm and
    ReLU, 32-d features: the JAX package's test-only net, f32 unless the
    config says otherwise."""

    def __init__(self, num_filters: int = 16, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv(3, num_filters, 3, 2, dtype, generator, same=True, init=lecun_normal_)
        self.bn0 = BatchNorm(num_filters, dtype)
        self.conv1 = Conv(num_filters, 2 * num_filters, 3, 2, dtype, generator, same=True,
                          init=lecun_normal_)
        self.bn1 = BatchNorm(2 * num_filters, dtype)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn0(self.conv0(x), train, update_stats))
        x = F.relu(self.bn1(self.conv1(x), train, update_stats))
        return {"features": x.mean(dim=(2, 3)).float()}


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


@BACKBONES.register("resnet50")
def resnet50(**kwargs):
    return _resnet([3, 4, 6, 3], kwargs, block=Bottleneck)


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


@BACKBONES.register("cifar_resnet32_V2", aliases=("cifar_resnet32_bic",))
def cifar_resnet32_bic(**kwargs):
    """cifar_resnet32_V2: BiC's pre-activation CIFAR ResNet (the bias layers
    live in the bic method)."""
    return PreActCifarResNet(32, dtype=kwargs.get("dtype", torch.bfloat16),
                             generator=kwargs.get("generator"))


@BACKBONES.register("tiny_cnn")
def tiny_cnn(**kwargs):
    return TinyCNN(dtype=kwargs.get("dtype", torch.float32), generator=kwargs.get("generator"))


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
