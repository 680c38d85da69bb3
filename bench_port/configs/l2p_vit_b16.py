"""L2P on ViT-B/16: the model's operations an image, its leaves, and its
plain reference (float32, no kernels of the program).

The reference follows Wang et al., "Learning to Prompt for Continual
Learning" (CVPR 2022): a frozen ViT-B/16 gives each image's CLS query; each
image picks the top-k of the pool's keys by cosine similarity, the batch's
majority picks the k prompts (ties to the lower index), which are prepended
to the patch tokens of a second pass; the mean of the prompt positions'
final features feeds the linear head. The loss is CE over the current
task's classes minus ``pull_constraint_coeff`` times the mean similarity of
each image to the chosen keys; the gradients are clipped to global norm 1.0
and Adam updates the prompts, the keys and the head. Departures, kept as the
program has them: the blocks' LayerNorm eps is 1e-5 (the final one 1e-6),
the majority vote counts only images of non-zero weight.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from bench_port import plain

BLOCK_EPS, FINAL_EPS = 1e-5, 1e-6
#: (width, depth, heads, MLP width, patch, image) of the backbones by name:
#: ViT-B/16 (Dosovitskiy et al.) and the port's small test ViT
VITS = {"vit_pt_imnet": (768, 12, 12, 3072, 16, 224), "vit_tiny_test": (64, 4, 4, 256, 8, 32)}


def _shape(config: Dict) -> Dict:
    k = config["classifier"]["kwargs"]
    width, depth, heads, mlp, patch, image = VITS[config["backbone"]["name"]]
    return {"width": width, "depth": depth, "heads": heads, "mlp": mlp, "patch": patch,
            "image": image, "tokens": (image // patch) ** 2 + 1,
            "prompts": int(k["prompt_length"]) * int(k["top_k"]),
            "pool": int(k["pool_size"]), "length": int(k["prompt_length"]),
            "classes": int(k["num_class"])}


def _block_flops(sh: Dict, s: int, backward: bool) -> float:
    """One block's products at S tokens: the qkv, proj and MLP projections
    (the backward: their input gradients only, the ViT is frozen) and
    attention's two products (four in the backward)."""
    d = sh["width"]
    linear = 2 * s * d * (3 * d + d + 2 * sh["mlp"])
    attn = 2 * s * s * d * (4 if backward else 2)
    return linear + attn


def flops_per_image(config: Dict, traffic: Dict) -> float:
    """The frozen query pass at S 197, the prompted pass at S 222 and its
    backward to the prompts; the patch embedding in each forward; the head
    forward and backward. Recomputation is not counted."""
    sh = _shape(config)
    s0, s1 = sh["tokens"], sh["tokens"] + sh["prompts"]
    embed = 2 * (sh["tokens"] - 1) * 3 * sh["patch"] ** 2 * sh["width"]
    head = 3 * 2 * sh["width"] * sh["classes"]
    blocks = (_block_flops(sh, s0, False) + _block_flops(sh, s1, False)
              + _block_flops(sh, s1, True))
    return sh["depth"] * blocks + 2 * embed + head


def weight_spec(config: Dict) -> List:
    """The frozen ViT in bf16, the trainable head and prompt pool in f32."""
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
    spec += [("params", "prompt.prompt", (sh["pool"], sh["length"], width), "uniform", 1.0, 0.0,
              f32),
             ("params", "prompt.key", (sh["pool"], width), "uniform", 1.0, 0.0, f32)]
    return spec


#: where each group of leaves lives in the program's training state
GROUPS = {"params": lambda state: state.params, "frozen": lambda state: state.mvars["frozen"]}


# ------------------------------------------------------------------ reference


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def vit(sh: Dict, W: Dict[str, torch.Tensor], x: torch.Tensor, pr: plain.Precision,
        prompts: torch.Tensor = None) -> torch.Tensor:
    """Final-norm tokens of the ViT on NHWC images in [0, 1], with
    ``prompts`` (B, P, D) in front of [CLS; patches] when given."""
    b, width, heads, patch = x.shape[0], sh["width"], sh["heads"], sh["patch"]
    g = sh["image"] // patch
    patches = (x.reshape(b, g, patch, g, patch, 3).permute(0, 1, 3, 5, 2, 4)
               .reshape(b, g * g, 3 * patch * patch))  # (C, kh, kw) per patch
    t = pr.linear(patches, W["patch_embed.weight"].reshape(width, -1), W["patch_embed.bias"])
    t = pr.act(torch.cat([W["cls_token"].expand(b, 1, width), t], dim=1) + W["pos_embed"])
    if prompts is not None:
        t = torch.cat([pr.act(prompts), t], dim=1)
    s = t.shape[1]
    hd = width // heads
    for i in range(sh["depth"]):
        p = f"blocks.{i}."
        h = pr.act(_layer_norm(t, W[p + "ln_1.weight"], W[p + "ln_1.bias"], BLOCK_EPS))
        qkv = pr.linear(h, W[p + "attn.qkv.weight"], W[p + "attn.qkv.bias"])
        q, k, v = (qkv[..., j * width:(j + 1) * width].reshape(b, s, heads, hd).transpose(1, 2)
                   for j in range(3))
        a = torch.softmax(pr.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = pr.matmul(a, v).transpose(1, 2).reshape(b, s, width)
        t = pr.act(t + pr.linear(o, W[p + "attn.proj.weight"], W[p + "attn.proj.bias"]))
        h = pr.act(_layer_norm(t, W[p + "ln_2.weight"], W[p + "ln_2.bias"], BLOCK_EPS))
        h = pr.act(F.gelu(pr.linear(h, W[p + "mlp.fc1.weight"], W[p + "mlp.fc1.bias"])))
        t = pr.act(t + pr.linear(h, W[p + "mlp.fc2.weight"], W[p + "mlp.fc2.bias"]))
    return _layer_norm(t, W["norm.weight"], W["norm.bias"], FINAL_EPS)


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest along the last axis, ties to the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def reference(config: Dict, weights: Dict, batches: List[Dict], aug_seed: int, task: int,
              control: str = "") -> Dict:
    """Follow ``batches`` from ``weights``: {losses, grad, change}.
    ``control`` "fp8" computes in e4m3 where the program computes in bf16
    (``plain.Precision``); "half" leaves out the
    second half of every batch."""
    kw = config["classifier"]["kwargs"]
    sh = _shape(config)
    top_k, coeff = int(kw["top_k"]), float(kw["pull_constraint_coeff"])
    trfm = {list(t)[0]: list(t.values())[0] or {} for t in config["train_trfms"]}
    rrc = trfm["RandomResizedCrop"]
    dev = batches[0]["image"].device
    pr = plain.Precision(control == "fp8")
    frozen = {n: t.float() for n, t in weights["frozen"].items()}
    params = {n: t.float().clone() for n, t in weights["params"].items()}
    lo = 0 if task == 0 else int(config["init_cls_num"]) + (task - 1) * int(config["inc_cls_num"])
    hi = lo + int(config["init_cls_num"] if task == 0 else config["inc_cls_num"])
    cls = torch.arange(int(kw["num_class"]), device=dev)
    current = (cls >= lo) & (cls < hi)
    gen = torch.Generator(device=dev)
    gen.manual_seed(aug_seed)

    def loss_fn(P, batch, step):
        w = batch["weight"].float().clone()
        if control == "half":
            w[w.shape[0] // 2:] = 0.0
        x = batch["image"].float() / 255.0
        x = plain.random_resized_crop(gen, x, int(rrc["size"]), rrc["scale"], rrc["ratio"])
        x = plain.random_flip(gen, x, float(trfm["RandomHorizontalFlip"].get("p", 0.5)))
        with torch.no_grad():
            query = _unit(vit(sh, frozen, x, pr)[:, 0])
        keys = _unit(P["prompt.key"])
        pool = P["prompt.key"].shape[0]
        picks = _top_k(query @ keys.t(), top_k)
        counts = (F.one_hot(picks, pool).float() * w[:, None, None]).sum(dim=(0, 1))
        major = _top_k(counts, top_k)
        prompts = P["prompt.prompt"][major].reshape(1, -1, sh["width"]).expand(x.shape[0], -1, -1)
        pull = plain.weighted_mean(torch.sum(keys[major][None] * query[:, None], dim=-1).sum(-1),
                                   w)
        tokens = vit(sh, frozen, x, pr, prompts)
        feats = tokens[:, :prompts.shape[1]].mean(dim=1)
        logits = pr.linear(feats, P["head.dense.weight"], P["head.dense.bias"])
        ce = plain.cross_entropy(logits, batch["label"], w, current, -math.inf)
        return ce - coeff * pull

    return plain.follow(loss_fn, params, batches, config["optimizer"],
                        lambda grads: plain.clip_global_norm(grads, 1.0))
