"""DualPrompt on ViT-B/16: the model's operations an image, its leaves, and its
plain reference (float32 with TF32 off, no kernels of the program).

The reference follows Wang et al., "DualPrompt: Complementary Prompting for
Rehearsal-free Continual Learning" (ECCV 2022, arXiv:2204.04799), whose
prompts enter by prefix-tuning. A frozen ViT-B/16 gives each image's query,
its final-norm CLS token, normalised. A second pass puts a prompt in front of
the keys and values of five blocks: blocks 0-1 take the shared G-prompt
``g_p_l`` (length 6), blocks 2-4 the task's E-prompt ``e_p_l[task]`` (length
20). Each prompt's first half joins every image's and head's keys, its second
half the values, with no projection, under one softmax over P + S keys; the
queries stay the S image tokens. The final-norm CLS of the second pass feeds
the linear head. The loss is CE over the seen classes, with the earlier
tasks' logits at -inf, plus the matching term
``sum_b w_b (1 - cos(q_b, e_k_l[task]))`` of each E-layer; the gradients are
clipped to global norm 1.0 and Adam updates the prompts, the keys and the
head.

Departures of the program from the paper, which the reference copies:

* the blocks' LayerNorm eps is 1e-5 (the final norm's 1e-6);
* the matching term is a weighted sum over the batch, not a mean;
* the term is counted once per E-layer, each layer with keys of its own;
* a prompt layer past the model's depth (the port's 4-block test ViT has no
  block 4) puts no prefix anywhere, and its key still counts in the term.

The train transforms are the configuration's RandomResizedCrop and flip or,
where it names none (as the shipped DualPrompt config), the port's ViT
preset: RandomResizedCrop to 224 at scale (0.08, 1) and ratio (3/4, 4/3), a
flip at p 0.5, and a normalisation by mean 0 and deviation 1, which changes
nothing.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from bench_port import plain
from bench_port.configs.l2p_vit_b16 import (  # noqa: F401  (GROUPS: the same groups)
    BLOCK_EPS, FINAL_EPS, GROUPS, VITS, _layer_norm, _unit)

#: the blocks that take the shared G-prompt, and those that take the task's E-prompt
G_LAYERS, E_LAYERS = (0, 1), (2, 3, 4)
#: the port's ViT train preset, where a configuration names no ``train_trfms``
VIT_TRAIN_PRESET = {"RandomResizedCrop": {"size": 224, "scale": (0.08, 1.0),
                                          "ratio": (3.0 / 4.0, 4.0 / 3.0)},
                    "RandomHorizontalFlip": {"p": 0.5}}


def _shape(config: Dict) -> Dict:
    k = config["classifier"]["kwargs"]
    width, depth, heads, mlp, patch, image = VITS[config["backbone"]["name"]]
    return {"width": width, "depth": depth, "heads": heads, "mlp": mlp, "patch": patch,
            "image": image, "tokens": (image // patch) ** 2 + 1,
            "g_len": int(k.get("g_prompt_length", 6)), "e_len": int(k.get("e_prompt_length", 20)),
            "pool": int(k.get("pool_size", 10)), "classes": int(k["num_class"])}


def _prefix_keys(sh: Dict, block: int) -> int:
    """The prompt keys in front of ``block``'s own."""
    if block in G_LAYERS:
        return sh["g_len"] // 2
    return sh["e_len"] // 2 if block in E_LAYERS else 0


def _block_flops(sh: Dict, s: int, keys: int, backward: bool) -> float:
    """One block's products at S query tokens over ``keys`` keys: the qkv,
    proj and MLP projections (the backward: their input gradients only, the
    ViT is frozen) and attention's two products (four in the backward)."""
    d = sh["width"]
    return 2 * s * d * (3 * d + d + 2 * sh["mlp"]) + 2 * s * keys * d * (4 if backward else 2)


def flops_per_image(config: Dict, traffic: Dict) -> float:
    """The frozen query pass at S 197; the prompted pass, whose prefix blocks
    attend over 197 + P keys, and its backward through every block (the
    G-prompt of block 0 takes a gradient); the patch embedding in each
    forward; the head forward and backward. The matching term's cosines and
    recomputation are not counted."""
    sh = _shape(config)
    s = sh["tokens"]
    query = sh["depth"] * _block_flops(sh, s, s, False)
    prompted = sum(_block_flops(sh, s, s + _prefix_keys(sh, i), False)
                   + _block_flops(sh, s, s + _prefix_keys(sh, i), True)
                   for i in range(sh["depth"]))
    embed = 2 * (s - 1) * 3 * sh["patch"] ** 2 * sh["width"]
    head = 3 * 2 * sh["width"] * sh["classes"]
    return query + prompted + 2 * embed + head


def weight_spec(config: Dict) -> List:
    """The frozen ViT in bf16, the trainable head in f32, and the prompts and
    keys uniform on [0, 1) in f32, as the program draws them."""
    sh = _shape(config)
    width, mlp, patch = sh["width"], sh["mlp"], sh["patch"]
    bf = "bfloat16" if config.get("dtype", "bfloat16") == "bfloat16" else "float32"
    f32 = "float32"

    def lin(prefix, out_f, in_f, group="frozen", dtype=bf):
        return [(group, f"{prefix}.weight", (out_f, in_f), "normal", in_f ** -0.5, 0.0, dtype),
                (group, f"{prefix}.bias", (out_f,), "normal", 0.02, 0.0, dtype)]

    def norm(prefix):
        return [("frozen", f"{prefix}.weight", (width,), "normal", 0.02, 1.0, bf),
                ("frozen", f"{prefix}.bias", (width,), "normal", 0.02, 0.0, bf)]

    def uniform(name, shape):
        return ("params", f"prompt.{name}", shape, "uniform", 1.0, 0.0, f32)

    spec = [("frozen", "patch_embed.weight", (width, 3, patch, patch), "normal",
             (3 * patch * patch) ** -0.5, 0.0, bf),
            ("frozen", "patch_embed.bias", (width,), "normal", 0.02, 0.0, bf),
            ("frozen", "cls_token", (1, 1, width), "normal", 0.02, 0.0, bf),
            ("frozen", "pos_embed", (1, sh["tokens"], width), "normal", 0.02, 0.0, bf)]
    for i in range(sh["depth"]):
        b = f"blocks.{i}"
        spec += (norm(f"{b}.ln_1") + lin(f"{b}.attn.qkv", 3 * width, width)
                 + lin(f"{b}.attn.proj", width, width) + norm(f"{b}.ln_2")
                 + lin(f"{b}.mlp.fc1", mlp, width) + lin(f"{b}.mlp.fc2", width, mlp))
    spec += norm("norm")
    spec += lin("head.dense", sh["classes"], width, group="params", dtype=f32)
    spec += [uniform(f"g_p_{g}", (sh["g_len"], width)) for g in G_LAYERS]
    for e in E_LAYERS:
        spec += [uniform(f"e_p_{e}", (sh["pool"], sh["e_len"], width)),
                 uniform(f"e_k_{e}", (sh["pool"], width))]
    return spec


# ------------------------------------------------------------------ reference


def vit(sh: Dict, W: Dict[str, torch.Tensor], x: torch.Tensor, pr: plain.Precision,
        prefixes: Dict[int, tuple] = None) -> torch.Tensor:
    """Final-norm tokens of the ViT on NHWC images in [0, 1]. ``prefixes[i]``,
    where given, is block i's prompt ``(pk, pv)``, each (P, D): every image's
    and head's P keys and values in front of its own."""
    b, width, heads, patch = x.shape[0], sh["width"], sh["heads"], sh["patch"]
    g = sh["image"] // patch
    patches = (x.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 5, 2, 4)
               .reshape(b, g * g, 3 * patch * patch))  # (C, kh, kw) per patch
    t = pr.linear(patches, W["patch_embed.weight"].reshape(width, -1), W["patch_embed.bias"])
    t = pr.act(torch.cat([W["cls_token"].expand(b, 1, width), t], dim=1) + W["pos_embed"])
    s = t.shape[1]
    hd = width // heads

    def split(y):  # (B or 1, n, D) -> (B or 1, heads, n, hd)
        return y.reshape(y.shape[0], -1, heads, hd).transpose(1, 2)

    for i in range(sh["depth"]):
        p = f"blocks.{i}."
        h = pr.act(_layer_norm(t, W[p + "ln_1.weight"], W[p + "ln_1.bias"], BLOCK_EPS))
        qkv = pr.linear(h, W[p + "attn.qkv.weight"], W[p + "attn.qkv.bias"])
        q, k, v = (split(qkv[..., j * width:(j + 1) * width]) for j in range(3))
        if prefixes and i in prefixes:
            pk, pv = (split(pr.act(y)[None]).expand(b, -1, -1, -1) for y in prefixes[i])
            k, v = torch.cat([pk, k], dim=2), torch.cat([pv, v], dim=2)
        a = torch.softmax(pr.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = pr.matmul(a, v).transpose(1, 2).reshape(b, s, width)
        t = pr.act(t + pr.linear(o, W[p + "attn.proj.weight"], W[p + "attn.proj.bias"]))
        h = pr.act(_layer_norm(t, W[p + "ln_2.weight"], W[p + "ln_2.bias"], BLOCK_EPS))
        h = pr.act(F.gelu(pr.linear(h, W[p + "mlp.fc1.weight"], W[p + "mlp.fc1.bias"])))
        t = pr.act(t + pr.linear(h, W[p + "mlp.fc2.weight"], W[p + "mlp.fc2.bias"]))
    return _layer_norm(t, W["norm.weight"], W["norm.bias"], FINAL_EPS)


def _prefixes(sh: Dict, P: Dict[str, torch.Tensor], task: int) -> Dict[int, tuple]:
    """Each prompt block's ``(pk, pv)``, the first and second halves of its
    prompt, for the blocks the model has."""
    out = {}
    for i in G_LAYERS + E_LAYERS:
        if i < sh["depth"]:
            prompt = P[f"prompt.g_p_{i}"] if i in G_LAYERS else P[f"prompt.e_p_{i}"][task]
            half = prompt.shape[0] // 2
            out[i] = (prompt[:half], prompt[half:])
    return out


def _augment(config: Dict, gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """The train transforms (see the module's docstring), drawing from ``gen``
    in the program's order."""
    trfm = {list(t)[0]: list(t.values())[0] or {} for t in config.get("train_trfms") or []}
    trfm = trfm or VIT_TRAIN_PRESET
    rrc = trfm["RandomResizedCrop"]
    x = plain.random_resized_crop(gen, x, int(rrc["size"]), rrc.get("scale", (0.08, 1.0)),
                                  rrc.get("ratio", (3.0 / 4.0, 4.0 / 3.0)))
    return plain.random_flip(gen, x, float(trfm["RandomHorizontalFlip"].get("p", 0.5)))


def reference(config: Dict, weights: Dict, batches: List[Dict], aug_seed: int, task: int,
              control: str = "") -> Dict:
    """Follow ``batches`` from ``weights``: {losses, grad, change}.
    ``control`` "fp8" computes in e4m3 where the program computes in bf16
    (``plain.Precision``); "half" leaves out the second half of every
    batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sh = _shape(config)
    dev = batches[0]["image"].device
    pr = plain.Precision(control == "fp8")
    frozen = {n: t.float() for n, t in weights["frozen"].items()}
    params = {n: t.float().clone() for n, t in weights["params"].items()}
    lo = 0 if task == 0 else int(config["init_cls_num"]) + (task - 1) * int(config["inc_cls_num"])
    hi = lo + int(config["init_cls_num"] if task == 0 else config["inc_cls_num"])
    cls = torch.arange(sh["classes"], device=dev)
    seen, earlier = cls < hi, cls < lo
    gen = torch.Generator(device=dev)
    gen.manual_seed(aug_seed)

    def loss_fn(P, batch, step):
        w = batch["weight"].float().clone()
        if control == "half":
            w[w.shape[0] // 2:] = 0.0
        x = _augment(config, gen, batch["image"].float() / 255.0)
        with torch.no_grad():
            query = _unit(vit(sh, frozen, x, pr)[:, 0])
        match = sum(torch.sum(w * (1.0 - query @ _unit(P[f"prompt.e_k_{e}"][task])))
                    for e in E_LAYERS)
        feats = vit(sh, frozen, x, pr, _prefixes(sh, P, task))[:, 0]
        logits = pr.linear(feats, P["head.dense.weight"], P["head.dense.bias"])
        logits = torch.where(earlier[None, :], -math.inf, logits)
        return plain.cross_entropy(logits, batch["label"], w, seen, -1e30) + match

    return plain.follow(loss_fn, params, batches, config["optimizer"],
                        lambda grads: plain.clip_global_norm(grads, 1.0))
