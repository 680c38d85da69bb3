"""Batched image transforms on the device, over float NHWC tensors made from
uint8 NHWC batches (``libcontinual_tpu/data/transforms.py``).

Every resampling is a pair of small interpolation matrices applied as
matrix products, the same form as the JAX package, so the two agree to float
rounding. Random draws come from an explicit ``torch.Generator`` on the
batch's device; they cannot reproduce ``jax.random``'s bits, only its
distributions.

Documented deviations from torchvision, kept as they are in the JAX package
(they are the reference here):
  * RandomResizedCrop samples ONE box (clamped-fit fallback) where
    torchvision rejection-samples up to 10 times then center-crops, keeps
    continuous box sizes where torchvision rounds to integer pixels, and
    resamples with exact 2-tap bilinear where PIL antialiases when
    downscaling;
  * Resize is ``jax.image.resize``'s bilinear with antialias (a triangle
    kernel widened by the downscale factor, half-pixel centres, weights
    renormalised at the borders);
  * ColorJitter applies brightness, contrast, saturation and hue in that
    fixed order with one final clamp, and rotates hue in YIQ space.

Each random transform draws its offsets, factors or flags and hands them to
a deterministic function of them (:func:`crop_at`, :func:`jitter`,
:func:`hflip`, :func:`grayscale`), so a test can feed the JAX package's
draws to the port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NORM_PRESETS = {
    "cifar": ([0.5071, 0.4866, 0.4409], [0.2675, 0.2565, 0.2761]),
    "imagenet": ([0.4914, 0.4822, 0.4465], [0.2023, 0.1994, 0.2010]),
    "imagenet_default": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
    "alexnet_cifar": (
        [125.3 / 255, 123.0 / 255, 113.9 / 255],
        [63.0 / 255, 62.1 / 255, 66.7 / 255],
    ),
    "clip": (
        [0.48145466, 0.4578275, 0.40821073],
        [0.26862954, 0.26130258, 0.27577711],
    ),
}


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


# ------------------------------------------------------------------ primitives


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) weights of ``jax.image.resize(method="bilinear",
    antialias=True)`` along one axis (jax ``compute_weight_mat``)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=f32, device=device)
    x = (sample_f[None, :] - src[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)  # triangle kernel
    total = w.sum(dim=0, keepdim=True)
    ok = total.abs() > 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(ok, w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(images: torch.Tensor, size) -> torch.Tensor:
    h, w = _pair(size)
    _, ih, iw, _ = images.shape
    wy = resize_weights(ih, h, images.device)
    wx = resize_weights(iw, w, images.device)
    return torch.einsum("bhwc,hy,wx->byxc", images, wy, wx)


def _pad_to(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    _, ih, iw, _ = images.shape
    ph, pw = max(0, h - ih), max(0, w - iw)
    return torch.nn.functional.pad(
        images, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    )


def center_crop(images: torch.Tensor, size) -> torch.Tensor:
    th, tw = _pair(size)
    _, h, w, _ = images.shape
    if h < th or w < tw:
        images = _pad_to(images, max(h, th), max(w, tw))
        _, h, w, _ = images.shape
    i, j = (h - th) // 2, (w - tw) // 2
    return images[:, i:i + th, j:j + tw, :]


def _pad_hw(images: torch.Tensor, padding: int) -> torch.Tensor:
    return torch.nn.functional.pad(images, (0, 0, padding, padding, padding, padding))


def crop_at(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, size,
            padding: int = 0) -> torch.Tensor:
    """Zero-pad by ``padding``, then crop image i at offset ``(ys[i], xs[i])``."""
    th, tw = _pair(size)
    if padding:
        images = _pad_hw(images, padding)
    b = images.shape[0]
    dev = images.device
    rows = ys.long()[:, None] + torch.arange(th, device=dev)[None, :]  # (B, th)
    cols = xs.long()[:, None] + torch.arange(tw, device=dev)[None, :]  # (B, tw)
    bidx = torch.arange(b, device=dev)[:, None, None]
    return images[bidx, rows[:, :, None], cols[:, None, :]]


def random_crop(gen: torch.Generator, images: torch.Tensor, size, padding: int = 0):
    """torchvision ``RandomCrop(size, padding)``: zero padding, then a uniform
    offset per image."""
    th, tw = _pair(size)
    b, h, w, _ = images.shape
    h, w = h + 2 * padding, w + 2 * padding
    ys = torch.randint(0, h - th + 1, (b,), generator=gen, device=images.device)
    xs = torch.randint(0, w - tw + 1, (b,), generator=gen, device=images.device)
    return crop_at(images, ys, xs, size, padding)


def random_hflip(gen: torch.Generator, images: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    flip = torch.rand(images.shape[0], generator=gen, device=images.device) < p
    return hflip(images, flip)


def hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the images whose ``flip`` flag is set."""
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def _interp_matrix(coords: torch.Tensor, src: int) -> torch.Tensor:
    """(B, t, src) bilinear taps: row r holds (1 - frac, frac) at the two
    source pixels around ``coords[:, r]``, clamped to the image."""
    c0 = torch.floor(coords)
    frac = coords - c0
    i0 = torch.clamp(c0.long(), 0, src - 1)
    i1 = torch.clamp(i0 + 1, 0, src - 1)
    m = torch.zeros(coords.shape + (src,), dtype=torch.float32, device=coords.device)
    m.scatter_add_(-1, i0[..., None], (1.0 - frac)[..., None])
    m.scatter_add_(-1, i1[..., None], frac[..., None])
    return m


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_size) -> torch.Tensor:
    """Bilinear crop-and-resize with per-example boxes ``(y0, x0, h, w)`` in
    pixels, as ``Ry @ img @ Rx^T``."""
    _, h, w, _ = images.shape
    th, tw = _pair(out_size)
    dev = images.device
    y0, x0, bh, bw = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ty = torch.linspace(0.0, 1.0, th, device=dev)
    tx = torch.linspace(0.0, 1.0, tw, device=dev)
    ys = y0[:, None] + ty[None, :] * (bh[:, None] - 1.0)
    xs = x0[:, None] + tx[None, :] * (bw[:, None] - 1.0)
    ry = _interp_matrix(ys, h)  # (B, th, h)
    rx = _interp_matrix(xs, w)  # (B, tw, w)
    t = torch.einsum("bqh,bhwc->bqwc", ry, images.float())
    return torch.einsum("bqwc,bpw->bqpc", t, rx)


def random_resized_crop(
    gen: torch.Generator,
    images: torch.Tensor,
    size,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> torch.Tensor:
    """Uniform area in ``scale``, log-uniform aspect in ``ratio``; a box that
    does not fit is clamped to fit and centred."""
    b, h, w, _ = images.shape
    dev = images.device

    def uniform(lo, hi):
        return torch.rand(b, generator=gen, device=dev) * (hi - lo) + lo

    area = float(h * w)
    target_area = area * uniform(scale[0], scale[1])
    aspect = torch.exp(uniform(float(np.log(ratio[0])), float(np.log(ratio[1]))))
    bw = torch.sqrt(target_area * aspect)
    bh = torch.sqrt(target_area / aspect)
    ok = (bw <= w) & (bh <= h)
    bw = torch.where(ok, bw, torch.clamp(float(h) * aspect, max=float(w)))
    bh = torch.where(ok, bh, torch.clamp(float(w) / aspect, max=float(h)))
    y0max = torch.clamp(h - bh, min=0.0)
    x0max = torch.clamp(w - bw, min=0.0)
    y0 = torch.rand(b, generator=gen, device=dev) * y0max
    x0 = torch.rand(b, generator=gen, device=dev) * x0max
    y0 = torch.where(ok, y0, y0max / 2.0)
    x0 = torch.where(ok, x0, x0max / 2.0)
    boxes = torch.stack([y0, x0, bh, bw], dim=1)
    return crop_and_resize(images, boxes, size)


def _rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    r, g, b = images[..., 0], images[..., 1], images[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b)[..., None]


def jitter(images: torch.Tensor, brightness=None, contrast=None, saturation=None,
           hue=None) -> torch.Tensor:
    """ColorJitter with given per-image factors (B,) (None skips a step) and
    hue angles in turns: brightness, contrast, saturation, hue, then one
    clamp to [0, 1]."""
    def per_image(f):
        return f.reshape(-1, 1, 1, 1)

    if brightness is not None:
        images = images * per_image(brightness)
    if contrast is not None:
        mean = _rgb_to_gray(images).mean(dim=(1, 2, 3), keepdim=True)
        images = (images - mean) * per_image(contrast) + mean
    if saturation is not None:
        gray = _rgb_to_gray(images)
        images = gray + (images - gray) * per_image(saturation)
    if hue is not None:
        theta = hue.reshape(-1, 1, 1) * (2.0 * np.pi)
        y = _rgb_to_gray(images)[..., 0]
        r, g, bl = images[..., 0], images[..., 1], images[..., 2]
        i = 0.596 * r - 0.274 * g - 0.322 * bl
        q = 0.211 * r - 0.523 * g + 0.312 * bl
        cos, sin = torch.cos(theta), torch.sin(theta)
        i2 = i * cos - q * sin
        q2 = i * sin + q * cos
        images = torch.stack([y + 0.956 * i2 + 0.621 * q2,
                              y - 0.272 * i2 - 0.647 * q2,
                              y - 1.106 * i2 + 1.703 * q2], dim=-1)
    return torch.clamp(images, 0.0, 1.0)


def color_jitter(gen: torch.Generator, images: torch.Tensor, brightness: float = 0.0,
                 contrast: float = 0.0, saturation: float = 0.0, hue: float = 0.0):
    """torchvision ``ColorJitter``: each set component draws a factor per
    image in ``[max(0, 1 - v), 1 + v]`` (hue an angle in ``[-v, v]`` turns)."""
    b = images.shape[0]

    def uniform(lo, hi):
        return torch.rand(b, generator=gen, device=images.device) * (hi - lo) + lo

    def factor(v):
        return uniform(max(0.0, 1.0 - v), 1.0 + v) if v else None

    return jitter(images, factor(brightness), factor(contrast), factor(saturation),
                  uniform(-hue, hue) if hue else None)


def grayscale(images: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """The images whose ``on`` flag is set, in gray on all three channels."""
    gray = _rgb_to_gray(images).expand_as(images)
    return torch.where(on[:, None, None, None], gray, images)


def random_grayscale(gen: torch.Generator, images: torch.Tensor, p: float = 0.1):
    return grayscale(images, torch.rand(images.shape[0], generator=gen,
                                        device=images.device) < p)


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    mean_t = torch.as_tensor(mean, dtype=images.dtype, device=images.device)
    std_t = torch.as_tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean_t) / std_t


# ----------------------------------------------------------------- pipelines


class Pipeline:
    """A transform pipeline: ``(generator or None, uint8 NHWC) -> float NHWC``.
    With no generator the random steps take their eval form (RandomResizedCrop
    becomes Resize, RandomCrop a centre crop of the padded image; flips,
    jitter and grayscale are skipped)."""

    def __init__(self, steps: List[Tuple[str, Dict[str, Any]]]):
        self.steps = steps

    def __call__(self, gen: Optional[torch.Generator], images: torch.Tensor) -> torch.Tensor:
        x = images.float() / 255.0 if images.dtype == torch.uint8 else images
        for name, kw in self.steps:
            if name == "Resize":
                x = resize(x, kw.get("size"))
            elif name == "CenterCrop":
                x = center_crop(x, kw.get("size"))
            elif name == "RandomCrop":
                pad = kw.get("padding", 0)
                if gen is None:
                    x = center_crop(_pad_hw(x, pad) if pad else x, kw.get("size"))
                else:
                    x = random_crop(gen, x, kw.get("size"), pad)
            elif name == "RandomHorizontalFlip":
                if gen is not None:
                    x = random_hflip(gen, x, kw.get("p", 0.5))
            elif name == "ColorJitter":
                if gen is not None:
                    x = color_jitter(gen, x, kw.get("brightness", 0.0), kw.get("contrast", 0.0),
                                     kw.get("saturation", 0.0), kw.get("hue", 0.0))
            elif name == "RandomGrayscale":
                if gen is not None:
                    x = random_grayscale(gen, x, kw.get("p", 0.1))
            elif name == "RandomResizedCrop":
                if gen is None:
                    x = resize(x, kw.get("size"))
                else:
                    x = random_resized_crop(
                        gen, x, kw.get("size"),
                        tuple(kw.get("scale", (0.08, 1.0))),
                        tuple(kw.get("ratio", (0.75, 4.0 / 3.0))),
                    )
            elif name == "Normalize":
                x = normalize(x, kw["mean"], kw["std"])
            elif name in ("ToTensor", "_convert_to_rgb", "_convert_image_to_rgb"):
                pass  # storage is already RGB float NHWC here
            else:
                raise NotImplementedError(
                    f"transform '{name}' is not in the PyTorch port yet"
                )
        return x


def build_transform(
    spec: Optional[List[Dict[str, Dict[str, Any]]]] = None,
    *,
    dataset: str = "cifar",
    backbone: str = "resnet",
    mode: str = "train",
    image_size: int = 32,
) -> Pipeline:
    """A pipeline from a ``train_trfms``-style list, or the ViT, CLIP,
    AlexNet or resnet-style preset of the JAX package's ``build_transform``
    when no list is given."""
    if spec is not None:
        return Pipeline([(name, dict(params or {})) for item in spec
                         for name, params in item.items()])
    if backbone == "clip":  # the same for train and test: no random step
        mean, std = NORM_PRESETS["clip"]
        return Pipeline([("Resize", {"size": image_size}), ("CenterCrop", {"size": image_size}),
                         ("Normalize", {"mean": mean, "std": std})])
    if backbone == "resnet":
        return Pipeline(_resnet_steps(dataset, mode))
    if backbone == "alexnet":  # the same for train and test: no random step
        mean, std = NORM_PRESETS["alexnet_cifar"]
        return Pipeline([("Normalize", {"mean": mean, "std": std})])
    if backbone != "vit":
        raise NotImplementedError(
            f"preset transforms for backbone '{backbone}' are not in the PyTorch port yet"
        )
    mean, std = NORM_PRESETS["none"]
    if mode == "train":
        steps = [("RandomResizedCrop", {"size": 224}), ("RandomHorizontalFlip", {})]
    elif "cifar" in dataset:
        steps = [("Resize", {"size": 224})]
    else:
        steps = [("Resize", {"size": 256}), ("CenterCrop", {"size": 224})]
    return Pipeline(steps + [("Normalize", {"mean": mean, "std": std})])


def _resnet_steps(dataset: str, mode: str) -> List[Tuple[str, Dict[str, Any]]]:
    """The resnet-style preset: the CIFAR recipe (pad-4 random crop, flip,
    brightness jitter 63/255) at 32 px, the ImageNet one at 224 px; CIFAR
    statistics for CIFAR, the true ImageNet ones for tiny-imagenet and the
    CIFAR-10-like ones for every other dataset (the JAX package's table)."""
    cifar = "cifar" in dataset
    preset = "cifar" if cifar else ("imagenet_default" if dataset == "tiny-imagenet" else "imagenet")
    mean, std = NORM_PRESETS[preset]
    norm = [("Normalize", {"mean": mean, "std": std})]
    if mode != "train":
        return norm if cifar else [("Resize", {"size": 256}), ("CenterCrop", {"size": 224})] + norm
    crop = ("RandomCrop", {"size": 32, "padding": 4}) if cifar else ("RandomResizedCrop", {"size": 224})
    return [crop, ("RandomHorizontalFlip", {}), ("ColorJitter", {"brightness": 63 / 255})] + norm
