"""Plain PyTorch pieces of the references: the train transforms, the losses,
the optimizers and the lower-precision products of the control. Nothing here
imports the program; each function follows the published description of its
operation in float32.

The control ("fp8") computes the model in float8 e4m3 where the program
computes it in bfloat16: both operands of every product, every activation
the program stores in bf16 (each product's result, the norms' outputs, the
residual sums), and the gradient arriving at each of them in the backward,
are scaled to the format's range by their largest magnitude, rounded to
e4m3 and scaled back; the reductions inside a norm, a softmax or a loss stay
in float32, as the program keeps them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale."""
    s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded to e4m3 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Precision:
    """The arithmetic of a reference run: float32 (``control=False``), or
    the control's e4m3 products."""

    def __init__(self, control: bool = False):
        self.control = control

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand: rounded, with a straight-through gradient."""
        if not self.control:
            return x
        return x + (fp8_round(x) - x).detach()

    def act(self, y: torch.Tensor) -> torch.Tensor:
        """A stored activation: rounded, and so is its gradient."""
        return _RoundGrad.apply(self.operand(y)) if self.control else y

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.act(self.operand(a) @ self.operand(b))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        y = self.operand(x) @ self.operand(w).t()
        return self.act(y if b is None else y + b)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
        pad = (w.shape[-1] - 1) // 2
        return self.act(F.conv2d(self.operand(x), self.operand(w), None, stride, pad))


# ----------------------------------------------------------------- transforms


def uniform(gen: torch.Generator, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo


def bilinear_rows(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``img`` (B, H, W, C) sampled along H at ``coords`` (B, T): each output
    row mixes the two source rows around its coordinate (clamped to the
    image) by the coordinate's fraction."""
    h = img.shape[1]
    c0 = torch.floor(coords)
    frac = (coords - c0)[:, :, None, None]
    i0 = torch.clamp(c0.long(), 0, h - 1)
    i1 = torch.clamp(i0 + 1, 0, h - 1)
    b = torch.arange(img.shape[0], device=img.device)[:, None]
    return img[b, i0] * (1.0 - frac) + img[b, i1] * frac


def random_resized_crop(gen, x: torch.Tensor, size: int, scale, ratio) -> torch.Tensor:
    """One box a image: area uniform in ``scale`` of the image, aspect
    log-uniform in ``ratio`` (a box that does not fit is clamped to fit and
    centred), then bilinear resampling of the box's corners-inclusive grid to
    ``size`` x ``size``. Draws: area, aspect, top, left, each one a image."""
    b, h, w, _ = x.shape
    dev = x.device
    area = float(h * w) * uniform(gen, b, scale[0], scale[1], dev)
    aspect = torch.exp(uniform(gen, b, math.log(ratio[0]), math.log(ratio[1]), dev))
    bw, bh = torch.sqrt(area * aspect), torch.sqrt(area / aspect)
    fits = (bw <= w) & (bh <= h)
    bw = torch.where(fits, bw, torch.clamp(float(h) * aspect, max=float(w)))
    bh = torch.where(fits, bh, torch.clamp(float(w) / aspect, max=float(h)))
    y_room, x_room = torch.clamp(h - bh, min=0.0), torch.clamp(w - bw, min=0.0)
    top = torch.where(fits, torch.rand(b, generator=gen, device=dev) * y_room, y_room / 2.0)
    left = torch.where(fits, torch.rand(b, generator=gen, device=dev) * x_room, x_room / 2.0)
    t = torch.linspace(0.0, 1.0, size, device=dev)[None, :]
    rows = bilinear_rows(x, top[:, None] + t * (bh[:, None] - 1.0))  # (B, size, W, C)
    cols = bilinear_rows(rows.transpose(1, 2), left[:, None] + t * (bw[:, None] - 1.0))
    return cols.transpose(1, 2)


def random_crop(gen, x: torch.Tensor, size: int, padding: int) -> torch.Tensor:
    """Zero padding, then a uniform top-left corner a image. Draws: top, left."""
    b, h, w, _ = x.shape
    dev = x.device
    top = torch.randint(0, h + 2 * padding - size + 1, (b,), generator=gen, device=dev)
    left = torch.randint(0, w + 2 * padding - size + 1, (b,), generator=gen, device=dev)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    r = top[:, None] + torch.arange(size, device=dev)[None, :]
    c = left[:, None] + torch.arange(size, device=dev)[None, :]
    return xp[torch.arange(b, device=dev)[:, None, None], r[:, :, None], c[:, None, :]]


def random_flip(gen, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Mirror left-right where a uniform draw falls under ``p``."""
    flip = torch.rand(x.shape[0], generator=gen, device=x.device) < p
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def random_brightness(gen, x: torch.Tensor, v: float) -> torch.Tensor:
    """torchvision's ColorJitter(brightness=v): a factor a image, uniform in
    [max(0, 1 - v), 1 + v], then a clamp to [0, 1]."""
    f = uniform(gen, x.shape[0], max(0.0, 1.0 - v), 1.0 + v, x.device)
    return torch.clamp(x * f[:, None, None, None], 0.0, 1.0)


# --------------------------------------------------------------------- losses


def weighted_mean(per: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return torch.sum(per * weight) / torch.clamp(weight.sum(), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor,
                  keep: torch.Tensor, masked_value: float) -> torch.Tensor:
    """CE over the classes in ``keep`` (the others' logits set to
    ``masked_value``), weighted mean over the batch."""
    z = torch.where(keep[None, :], logits, torch.full_like(logits, masked_value))
    nll = -F.log_softmax(z, dim=-1).gather(1, labels[:, None])[:, 0]
    return weighted_mean(nll, weight)


def distillation(student: torch.Tensor, teacher: torch.Tensor, keep: torch.Tensor,
                 weight: torch.Tensor, temperature: float) -> torch.Tensor:
    """Hinton KD over the classes in ``keep``: ``-sum softmax(t/T) *
    log_softmax(s/T)``, weighted mean over the batch, no T^2 factor."""
    s = student[:, keep] / temperature
    t = teacher[:, keep] / temperature
    per = -torch.sum(F.softmax(t, dim=-1) * F.log_softmax(s, dim=-1), dim=-1)
    return weighted_mean(per, weight)


# ----------------------------------------------------------------- optimizers


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> None:
    """Scale every gradient by max_norm / norm when the global norm reaches
    max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if float(norm) >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)


class Adam:
    """Adam with bias correction and weight decay added to the gradient."""

    def __init__(self, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n] + self.wd * p if self.wd else grads[n]
                m = self.m.get(n, torch.zeros_like(p)) * self.b1 + (1 - self.b1) * g
                v = self.v.get(n, torch.zeros_like(p)) * self.b2 + (1 - self.b2) * g * g
                self.m[n], self.v[n] = m, v
                m_hat = m / (1 - self.b1 ** self.t)
                v_hat = v / (1 - self.b2 ** self.t)
                p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self.eps))


class SGD:
    """SGD with heavy-ball momentum (the first step's buffer is the
    gradient) and weight decay added to the gradient."""

    def __init__(self, momentum: float = 0.0, weight_decay: float = 0.0):
        self.mu, self.wd = momentum, weight_decay
        self.buf: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        with torch.no_grad():
            for n, p in params.items():
                d = grads[n] + self.wd * p if self.wd else grads[n]
                if self.mu:
                    d = d.clone() if n not in self.buf else self.buf[n] * self.mu + d
                    self.buf[n] = d
                p.sub_(lr * d)


def optimizer(node: Dict):
    """The reference optimizer of a config's ``optimizer`` node."""
    kw = node.get("kwargs") or {}
    name = node["name"].lower()
    if name == "adam":
        return Adam(tuple(kw.get("betas", (0.9, 0.999))), kw.get("eps", 1e-8),
                    kw.get("weight_decay", 0.0))
    if name == "sgd":
        return SGD(kw.get("momentum", 0.0), kw.get("weight_decay", 0.0))
    raise ValueError(f"no reference optimizer {node['name']!r}")


def follow(loss_fn, params: Dict[str, torch.Tensor], batches: List[Dict], opt_node: Dict,
           transform_grads=None) -> Dict:
    """Run ``loss_fn(params, batch, step)`` and an optimizer step over
    ``batches``; returns the losses, the first gradient a leaf (after
    ``transform_grads``; its norm and the tensor) and the norm of the
    parameters' change a leaf."""
    opt = optimizer(opt_node)
    start = {n: p.detach().clone() for n, p in params.items()}
    losses, first = [], None
    for i, batch in enumerate(batches):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, batch, i)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if transform_grads is not None:
            transform_grads(grads)
        if first is None:
            first = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grads.items()}
            first_vec = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(params, grads, float(batch["lr"]))
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
              for n, p in params.items()}
    return {"losses": losses, "grad": first, "grad_vec": first_vec, "change": change}
