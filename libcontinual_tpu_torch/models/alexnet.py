"""AlexNet backbones of the gradient-projection family, GPM, TRGP and API
(``libcontinual_tpu/models/alexnet.py``).

The published 3-conv / 2-fc net: 64k4, 128k3 and 256k2 VALID convolutions,
each followed by batch normalisation, ReLU, dropout and a 2x2 max pool, then
fc 1024 -> 2048 -> 2048. No bias anywhere. The normalisation always uses the
batch's statistics, in evaluation too (``BatchStatsNorm``: no running
statistics), so a prediction depends on the batch it is made in.

  * Images come in as NHWC floats and the convolutions run NCHW (cuDNN, as
    the JAX package leaves them to XLA). The flatten before fc3 is in
    ``(h, w, c)`` order, the JAX package's NHWC order, so fc3's 1024 inputs
    and every projection on them mean the same thing on both sides.
  * ``capture=True`` returns the inputs of the 5 projected layers as
    ``layer_inputs`` (a conv's NCHW, before the cast to the compute dtype);
    :func:`conv_patches` unfolds a conv input into rows in the flattened
    kernel order ``(kh, kw, C)``.
  * The projection space of a layer is its flattened input in ``(kh, kw, C)``
    order (:func:`kernel_rows` / :func:`rows_to_kernel` move an OIHW or
    ``(out, in)`` weight or gradient there and back), so the matrices are the
    JAX package's.
  * ``weight_override`` hands in the 5 layer weights (TRGP's effective
    weights, in the module's layout).
  * Dropout keep masks are inputs (``keep``, one boolean tensor a dropout
    layer, shaped as its activation, NCHW for the convs); the method draws
    them (:meth:`AlexNetTRGP.draw_keep`). Without them nothing is dropped.

``AlexNetAPI`` preallocates API's input expansion: every projected layer's
input gains ``slots * k_slot`` channels, each a learnable mix (``ws{i}``,
``(slots, base, k_slot)``) of the base channels, gated by ``ws_mask``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.models.resnet import kaiming_normal_
from libcontinual_tpu_torch.registry import BACKBONES

# layer geometry for 32x32 inputs
CONV_SPECS = [
    dict(features=64, kernel=4, in_ch=3, out_hw=29),
    dict(features=128, kernel=3, in_ch=64, out_hw=12),
    dict(features=256, kernel=2, in_ch=128, out_hw=5),
]
FC_SPECS = [dict(features=2048, in_dim=1024), dict(features=2048, in_dim=2048)]
LAYER_IN_FLAT = [3 * 16, 64 * 9, 128 * 4, 1024, 2048]
LAYER_NAMES = ("conv0", "conv1", "conv2", "fc3", "fc4")


def kernel_rows(w: torch.Tensor) -> torch.Tensor:
    """A layer weight (or its gradient) as ``(in_flat, out)`` rows: an OIHW
    conv weight flattened in ``(kh, kw, C)`` order, an ``(out, in)`` fc
    weight transposed (the JAX kernel's own layout)."""
    if w.dim() == 4:
        return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
    return w.t()


def rows_to_kernel(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`kernel_rows`, shaped as ``like``."""
    if like.dim() == 4:
        o, c, kh, kw = like.shape
        return rows.reshape(kh, kw, c, o).permute(3, 2, 0, 1)
    return rows.t()


def conv_patches(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """im2col of an NCHW input: ``(B * out_h * out_w, kh * kw * C)`` VALID
    patches, rows in ``(b, oh, ow)`` order and columns in the flattened
    kernel order ``(kh, kw, C)``."""
    b, c = x.shape[:2]
    cols = F.unfold(x, kernel)  # (B, C * kh * kw, L), channel-major
    cols = cols.reshape(b, c, kernel, kernel, -1).permute(0, 4, 2, 3, 1)
    return cols.reshape(-1, kernel * kernel * c)


class BatchStatsNorm(nn.Module):
    """Batch normalisation on the batch's statistics only, over the channels
    of an NCHW or ``(B, C)`` tensor, with the JAX module's rounding points:
    the mean and variance computed in f32 and rounded to the input's dtype,
    the normalisation in that dtype, the affine part in f32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        axes = (0, 2, 3) if x.dim() == 4 else (0,)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True).to(x.dtype)
        var = xf.var(dim=axes, unbiased=False, keepdim=True).to(x.dtype)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        return y.float() * self.weight.view(shape) + self.bias.view(shape)


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax ``Dropout``: the kept entries scaled by ``1 / (1 - rate)``."""
    if keep is None or rate <= 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class AlexNetTRGP(nn.Module):
    """``forward(x, capture=False, weight_override=None, keep=None)`` returns
    ``{"features"}`` (f32) and, with ``capture``, ``"layer_inputs"``: the
    inputs of the 5 projected layers, for GPM's activation SVDs."""

    BASE_IN = (3, 64, 128, 1024, 2048)

    def __init__(self, dropout1: float = 0.2, dropout2: float = 0.5, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, extra_in: int = 0):
        super().__init__()
        self.dropout1, self.dropout2, self.dtype = dropout1, dropout2, dtype
        e = extra_in
        for i, spec in enumerate(CONV_SPECS):
            k = spec["kernel"]
            setattr(self, f"conv{i}", nn.Parameter(torch.empty(spec["features"],
                                                               self.BASE_IN[i] + e, k, k)))
            setattr(self, f"bn{i}", BatchStatsNorm(spec["features"]))
        for j, spec in enumerate(FC_SPECS):
            setattr(self, f"fc{3 + j}", nn.Parameter(torch.empty(spec["features"],
                                                                 self.BASE_IN[3 + j] + e)))
            setattr(self, f"bn{3 + j}", BatchStatsNorm(spec["features"]))
        for name in LAYER_NAMES:
            kaiming_normal_(getattr(self, name), generator)

    def layer_weights(self) -> List[nn.Parameter]:
        """The 5 projected layers' weights, conv0 to fc4."""
        return [getattr(self, name) for name in LAYER_NAMES]

    def rates(self) -> List[float]:
        return [self.dropout1, self.dropout1, self.dropout2, self.dropout2, self.dropout2]

    def keep_shapes(self, batch: int) -> List[Sequence[int]]:
        """The activation shape at each dropout layer."""
        return ([(batch, s["features"], s["out_hw"], s["out_hw"]) for s in CONV_SPECS]
                + [(batch, s["features"]) for s in FC_SPECS])

    def draw_keep(self, gen: torch.Generator, batch: int, device) -> List[torch.Tensor]:
        """Keep masks of one training forward, from ``gen``."""
        return [torch.rand(shape, generator=gen, device=device) < 1.0 - rate
                for shape, rate in zip(self.keep_shapes(batch), self.rates())]

    def expand(self, i: int, x: torch.Tensor, ws_mask) -> torch.Tensor:
        """A projected layer's input as the layer reads it (API widens it)."""
        return x

    def forward(self, x, ws_mask=None, capture: bool = False,
                weight_override: Optional[Sequence[torch.Tensor]] = None,
                keep: Optional[Sequence[torch.Tensor]] = None) -> Dict:
        dt = self.dtype
        weights = list(weight_override) if weight_override is not None else self.layer_weights()
        rates = self.rates()
        captured = []
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = self.expand(i, x, ws_mask)
            if capture:
                captured.append(x)
            x = F.conv2d(x.to(dt), weights[i].to(dt))
            x = torch.relu(getattr(self, f"bn{i}")(x))
            x = dropout(x, keep[i] if keep is not None else None, rates[i])
            x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c): the JAX package's NHWC order
        for i in (3, 4):
            x = self.expand(i, x, ws_mask)
            if capture:
                captured.append(x)
            x = F.linear(x.to(dt), weights[i].to(dt))
            x = torch.relu(getattr(self, f"bn{i}")(x))
            x = dropout(x, keep[i] if keep is not None else None, rates[i])
        out = {"features": x.float()}
        if capture:
            out["layer_inputs"] = captured
        return out


class AlexNetAPI(AlexNetTRGP):
    """API's input-expandable AlexNet. Each projected layer reads
    ``cat([x] + [x @ ws{i}[s] * ws_mask[i][s] for each slot s])``: kernels
    preallocated with ``base + slots * k_slot`` inputs, so expansion is a
    mask flip and a slab write. Inactive extras are exactly zero, so their
    kernel rows get zero gradient until activated. ``forward`` takes
    ``ws_mask``, one ``(slots, k_slot)`` 0/1 tensor a layer."""

    def __init__(self, slots: int = 9, k_slot: int = 5, dropout1: float = 0.2,
                 dropout2: float = 0.5, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dropout1, dropout2, dtype, generator, extra_in=slots * k_slot)
        self.slots, self.k_slot = slots, k_slot
        for i, base in enumerate(self.BASE_IN):
            setattr(self, f"ws{i}", nn.Parameter(torch.zeros(slots, base, k_slot)))

    @property
    def extra_in(self) -> int:
        return self.slots * self.k_slot

    def in_flats(self) -> List[int]:
        e = self.extra_in
        return [(3 + e) * 16, (64 + e) * 9, (128 + e) * 4, 1024 + e, 2048 + e]

    def expand(self, i, x, ws_mask):
        dt = self.dtype
        ws = getattr(self, f"ws{i}").to(dt)
        m = ws_mask[i].to(dt)
        if x.dim() == 4:
            ex = torch.einsum("bchw,scj->bsjhw", x.to(dt), ws) * m[None, :, :, None, None]
            ex = ex.reshape(x.shape[0], self.extra_in, *x.shape[2:])
        else:
            ex = torch.einsum("bc,scj->bsj", x.to(dt), ws) * m[None]
            ex = ex.reshape(x.shape[0], self.extra_in)
        return torch.cat([x.to(dt), ex], dim=1)


@BACKBONES.register("AlexNet_TRGP", aliases=("alexnet_trgp", "AlexNet"))
def alexnet_trgp(**kwargs):
    return AlexNetTRGP(
        dropout1=float(kwargs.get("dropout1", kwargs.get("dropout_rate_1", 0.2))),
        dropout2=float(kwargs.get("dropout2", kwargs.get("dropout_rate_2", 0.5))),
        dtype=kwargs.get("dtype", torch.float32),
        generator=kwargs.get("generator"),
    )


@BACKBONES.register("AlexNet_API", aliases=("alexnet_api",))
def alexnet_api(**kwargs):
    return AlexNetAPI(
        slots=int(kwargs.get("task_num", 10)) - 1,
        k_slot=int(kwargs.get("k_slot", 5)),
        dtype=kwargs.get("dtype", torch.float32),
        generator=kwargs.get("generator"),
    )
