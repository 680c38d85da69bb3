"""iCaRL on cifar_resnet32: the model's operations an image, its leaves, and
its plain reference (float32, no kernels of the program).

The reference follows Rebuffi et al., "iCaRL: Incremental Classifier and
Representation Learning" (CVPR 2017) with the 32-layer CIFAR ResNet of He et
al.: a 3x3 stem of 16 filters, three stages of five basic blocks (16, 32, 64
filters; the first block of stages 2 and 3 at stride 2, with a 1x1
projection and its BatchNorm on the shortcut), the spatial mean as a 64-d
feature and a linear head. BatchNorm in training normalises by the batch's
mean and biased variance. The loss from the second task on is CE over the
seen classes plus temperature-2 distillation of the old classes' logits
against the previous task's network (the teacher, in train mode on the
batch's statistics), without the T^2 factor; SGD with momentum and weight
decay updates every leaf. The train transforms are the CIFAR recipe:
4-pixel zero padding and a random 32x32 crop, a random flip, a brightness
jitter of 63/255 and the CIFAR-100 normalisation.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port import plain

DEPTH, FILTERS, FEAT = 32, 16, 64
BN_EPS = 1e-5
CIFAR_MEAN = (0.5071, 0.4866, 0.4409)
CIFAR_STD = (0.2675, 0.2565, 0.2761)
BRIGHTNESS = 63 / 255


def _blocks():
    """(name, in, out, stride, projection) of every basic block."""
    n = (DEPTH - 2) // 6
    out, cin = [], FILTERS
    for stage in range(3):
        for j in range(n):
            filters = FILTERS * 2 ** stage
            stride = 2 if stage > 0 and j == 0 else 1
            out.append((f"blocks.{stage * n + j}", cin, filters, stride,
                        stride != 1 or cin != filters))
            cin = filters
    return out


def forward_macs(config: Dict, size: int = 32) -> int:
    """Multiply-adds of one image's forward pass, head included."""
    macs, hw = 9 * 3 * FILTERS * size * size, size * size
    for _, cin, cout, stride, proj in _blocks():
        out_hw = hw // (stride * stride)
        macs += 9 * cin * cout * out_hw + 9 * cout * cout * out_hw
        macs += cin * cout * out_hw if proj else 0
        hw = out_hw
    return macs + FEAT * int(config["classifier"]["kwargs"]["num_class"])


def flops_per_image(config: Dict, traffic: Dict) -> float:
    """The student's forward and backward with weight gradients (three
    forwards), plus the teacher's forward from the second task on."""
    fwd = 2 * forward_macs(config)
    return fwd * (3 + (1 if int(traffic.get("task", 0)) > 0 else 0))


def _resnet_spec(group: str, classes: int) -> List:
    f32 = "float32"

    def conv(name, cin, cout, k):
        return [(group, f"backbone.{name}.weight", (cout, cin, k, k), "normal",
                 (2.0 / (cin * k * k)) ** 0.5, 0.0, f32)]

    def bn(name, c):
        return [(group, f"backbone.{name}.weight", (c,), "normal", 0.1, 1.0, f32),
                (group, f"backbone.{name}.bias", (c,), "normal", 0.1, 0.0, f32),
                (group, f"backbone.{name}.running_mean", (c,), "normal", 0.0, 0.0, f32),
                (group, f"backbone.{name}.running_var", (c,), "normal", 0.0, 1.0, f32)]

    spec = conv("conv_stem", 3, FILTERS, 3) + bn("bn_stem", FILTERS)
    for name, cin, cout, _, proj in _blocks():
        spec += conv(f"{name}.conv0", cin, cout, 3) + bn(f"{name}.bn0", cout)
        spec += conv(f"{name}.conv1", cout, cout, 3) + bn(f"{name}.bn1", cout)
        if proj:
            spec += conv(f"{name}.downsample", cin, cout, 1) + bn(f"{name}.downsample_bn", cout)
    spec += [(group, "head.dense.weight", (classes, FEAT), "normal", FEAT ** -0.5, 0.0, f32),
             (group, "head.dense.bias", (classes,), "normal", 0.02, 0.0, f32)]
    return spec


def weight_spec(config: Dict) -> List:
    """The student and, drawn apart, the teacher."""
    classes = int(config["classifier"]["kwargs"]["num_class"])
    return _resnet_spec("params", classes) + _resnet_spec("teacher", classes)


#: where each group of leaves lives in the program's training state
GROUPS = {"params": lambda state: state.params, "teacher": lambda state: state.mvars["teacher"]}


# ------------------------------------------------------------------ reference


def _bn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    scale = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[:, None, None]) * scale[:, None, None] + b[:, None, None]


def resnet(W: Dict[str, torch.Tensor], x: torch.Tensor, pr: plain.Precision) -> torch.Tensor:
    """Logits of NHWC images, BatchNorm on the batch's statistics."""
    def cbn(t, conv, bn, stride):
        t = pr.conv2d(t, W[f"backbone.{conv}.weight"], stride)
        return pr.act(_bn(t, W[f"backbone.{bn}.weight"], W[f"backbone.{bn}.bias"]))

    t = torch.relu(cbn(x.permute(0, 3, 1, 2), "conv_stem", "bn_stem", 1))
    for name, _, _, stride, proj in _blocks():
        y = torch.relu(cbn(t, f"{name}.conv0", f"{name}.bn0", stride))
        y = cbn(y, f"{name}.conv1", f"{name}.bn1", 1)
        short = cbn(t, f"{name}.downsample", f"{name}.downsample_bn", stride) if proj else t
        t = torch.relu(pr.act(y + short))
    feats = t.mean(dim=(2, 3))
    return pr.linear(feats, W["head.dense.weight"], W["head.dense.bias"])


def reference(config: Dict, weights: Dict, batches: List[Dict], aug_seed: int, task: int,
              control: str = "") -> Dict:
    """Follow ``batches`` from ``weights``: {losses, grad, change}.
    ``control`` "fp8" computes in e4m3 where the program computes in bf16
    (``plain.Precision``); "half" leaves out the
    second half of every batch."""
    kw = config["classifier"]["kwargs"]
    dev = batches[0]["image"].device
    pr = plain.Precision(control == "fp8")
    params = {n: t.float().clone() for n, t in weights["params"].items()
              if not n.endswith(("running_mean", "running_var"))}
    teacher = {n: t.float() for n, t in weights["teacher"].items()}
    lo = 0 if task == 0 else int(config["init_cls_num"]) + (task - 1) * int(config["inc_cls_num"])
    hi = lo + int(config["init_cls_num"] if task == 0 else config["inc_cls_num"])
    cls = torch.arange(int(kw["num_class"]), device=dev)
    mean = torch.tensor(CIFAR_MEAN, device=dev)
    std = torch.tensor(CIFAR_STD, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(aug_seed)

    def loss_fn(P, batch, step):
        w = batch["weight"].float().clone()
        if control == "half":
            w[w.shape[0] // 2:] = 0.0
        x = batch["image"].float() / 255.0
        x = plain.random_crop(gen, x, 32, 4)
        x = plain.random_flip(gen, x, 0.5)
        x = plain.random_brightness(gen, x, BRIGHTNESS)
        x = (x - mean) / std
        logits = resnet(P, x, pr)
        loss = plain.cross_entropy(logits, batch["label"], w, cls < hi, -1e30)
        if task > 0:
            with torch.no_grad():
                t_logits = resnet(teacher, x, pr)
            loss = loss + plain.distillation(logits, t_logits, cls < lo, w,
                                             float(kw.get("T", 2.0)))
        return loss

    return plain.follow(loss_fn, params, batches, config["optimizer"])
