"""ResNet with CBAM channel and spatial attention
(``libcontinual_tpu/models/cbam.py``), the ``resnet18_cbam`` backbone.

As in the JAX module, and unlike the port's other ResNets:
  * it runs in f32 whatever the config's ``dtype`` says;
  * its convolutions pad as flax's ``SAME`` does (a stride-2 3x3 conv on an
    even input pads (0, 1), the ImageNet stem's 7x7 stride-2 conv (2, 3)),
    not with the ResNets' symmetric ``(k - 1) // 2``;
  * its convolutions and dense layers draw flax's default ``lecun_normal``
    (variance ``1 / fan_in``), the dense biases start at 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.models.resnet import BatchNorm, Conv, _is_cifar, lecun_normal_
from libcontinual_tpu_torch.registry import BACKBONES

F32 = torch.float32


def _dense(cin: int, cout: int, gen: Optional[torch.Generator]) -> nn.Linear:
    """flax ``nn.Dense``: a ``lecun_normal`` kernel and a zero bias."""
    lin = nn.Linear(cin, cout)
    lecun_normal_(lin.weight, gen)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class ChannelGate(nn.Module):
    """One shared MLP (c -> c / 16 -> c) on the spatially averaged and on the
    spatially max-pooled vectors; the sigmoid of their sum scales the
    channels."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = _dense(channels, channels // reduction, generator)
        self.fc1 = _dense(channels // reduction, channels, generator)

    def _mlp(self, v):
        return self.fc1(F.relu(self.fc0(v)))

    def forward(self, x):
        scale = torch.sigmoid(self._mlp(x.mean(dim=(2, 3))) + self._mlp(x.amax(dim=(2, 3))))
        return x * scale[:, :, None, None]


class SpatialGate(nn.Module):
    """A 7x7 conv of [channel max, channel mean] and a BatchNorm; its sigmoid
    scales the pixels."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(2, 1, 7, 1, F32, generator, same=True, init=lecun_normal_)
        self.bn = BatchNorm(1, F32)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        s = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.bn(self.conv(s), train, update_stats))


class CBAMBasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        conv = dict(dtype=F32, generator=generator, same=True, init=lecun_normal_)
        self.conv0 = Conv(cin, filters, 3, stride, **conv)
        self.bn0 = BatchNorm(filters, F32)
        self.conv1 = Conv(filters, filters, 3, 1, **conv)
        self.bn1 = BatchNorm(filters, F32)
        self.channel_gate = ChannelGate(filters, generator=generator)
        self.spatial_gate = SpatialGate(generator)
        self.downsample = self.downsample_bn = None
        if stride != 1 or cin != filters:
            self.downsample = Conv(cin, filters, 1, stride, **conv)
            self.downsample_bn = BatchNorm(filters, F32)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        y = F.relu(self.bn0(self.conv0(x), train, update_stats))
        y = self.channel_gate(self.bn1(self.conv1(y), train, update_stats))
        y = self.spatial_gate(y, train, update_stats)
        residual = x
        if self.downsample is not None:
            residual = self.downsample_bn(self.downsample(x), train, update_stats)
        return F.relu(y + residual)


class CBAMResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_filters: int = 64,
                 cifar_stem: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cifar_stem, self.dtype = cifar_stem, F32
        self.conv_stem = Conv(3, num_filters, 3 if cifar_stem else 7, 1 if cifar_stem else 2,
                              F32, generator, same=True, init=lecun_normal_)
        self.bn_stem = BatchNorm(num_filters, F32)
        blocks, cin = [], num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = num_filters * 2 ** i
                blocks.append(CBAMBasicBlock(cin, filters, 2 if i > 0 and j == 0 else 1,
                                             generator))
                cin = filters
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        x = x.permute(0, 3, 1, 2).float()
        x = F.relu(self.bn_stem(self.conv_stem(x), train, update_stats))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for blk in self.blocks:
            x = blk(x, train, update_stats)
        return {"features": x.mean(dim=(2, 3))}


@BACKBONES.register("resnet18_cbam")
def resnet18_cbam(**kwargs):
    """resnet18 with CBAM in every block; f32 whatever ``dtype`` says."""
    return CBAMResNet([2, 2, 2, 2], cifar_stem=_is_cifar(kwargs),
                      generator=kwargs.get("generator"))
