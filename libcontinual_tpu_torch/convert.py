"""The weight bridge: the JAX package's parameters, as nested dicts of numpy
arrays, into the port's modules.

Layout maps (the inverse of ``_load_timm_torch_into`` in
``libcontinual_tpu/models/vit.py``):
  * Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``; the qkv
    projection stays packed as ``[q | k | v]``;
  * Conv ``kernel (H, W, I, O)`` -> Conv2d ``weight (O, I, H, W)``;
  * LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
  * ``cls_token`` and ``pos_embed`` as they are;
  * L2P's ``{"head": {"Dense_0": ...}, "prompt": {"prompt", "key"}}``;
  * DualPrompt's, CODA-Prompt's and DAP's ``{"head": {"Dense_0": ...},
    "prompt": {name: array}}``, name for name into the method's
    ``nn.ParameterDict``;
  * a ResNet's ``conv_stem`` / ``bn_stem`` and ``BasicBlock_{i}`` subtrees
    (``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ``BatchNorm_1`` and, where the
    shapes change, ``downsample`` / ``downsample_bn``), the BatchNorm
    ``scale`` / ``bias`` with the ``batch_stats`` ``mean`` / ``var`` as the
    running buffers; the rehearsal methods' ``{"backbone", "head"}`` tree,
    iCaRL's teacher and class means;
  * the CLIP tree (both towers, ``ln_pre_n``, ``token_embedding``,
    ``pos_embed``, both projections, ``logit_scale``) and the MoE leaves
    (``w_gate``, ``w_noise``, ``down``, ``down_b``, ``up``, ``up_b``) as they
    are; MoE-Adapter4CL's ``params["clip"]`` merged with its
    ``mvars["frozen"]``; RAPF's adapter kernel and its ``mvars``.

Values are copied into the modules' existing tensors, so each module keeps
its own dtype and device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

Tree = Dict[str, Any]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _put(dst: torch.Tensor, value: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(value.shape):
        raise ValueError(f"{name}: source {tuple(value.shape)} vs module {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(value)


def load_dense(lin: nn.Linear, p: Tree, name: str = "dense") -> None:
    _put(lin.weight, _tensor(p["kernel"]).T, f"{name}.kernel")
    _put(lin.bias, _tensor(p["bias"]), f"{name}.bias")


def load_layer_norm(ln: nn.LayerNorm, p: Tree, name: str = "norm") -> None:
    _put(ln.weight, _tensor(p["scale"]), f"{name}.scale")
    _put(ln.bias, _tensor(p["bias"]), f"{name}.bias")


def load_conv(conv: nn.Module, p: Tree, name: str = "conv") -> None:
    _put(conv.weight, _tensor(p["kernel"]).permute(3, 2, 0, 1), f"{name}.kernel")


def load_batch_norm(bn: nn.Module, p: Tree, stats: Tree, name: str = "bn") -> None:
    _put(bn.weight, _tensor(p["scale"]), f"{name}.scale")
    _put(bn.bias, _tensor(p["bias"]), f"{name}.bias")
    _put(bn.running_mean, _tensor(stats["mean"]), f"{name}.mean")
    _put(bn.running_var, _tensor(stats["var"]), f"{name}.var")


def load_resnet(resnet: nn.Module, p: Tree, stats: Tree) -> None:
    """A flax ``ResNet`` / ``CifarResNet`` (``params`` and ``batch_stats``)
    into a port ``ResNet``."""
    load_conv(resnet.conv_stem, p["conv_stem"], "conv_stem")
    load_batch_norm(resnet.bn_stem, p["bn_stem"], stats["bn_stem"], "bn_stem")
    n_blocks = len([k for k in p if k.startswith("BasicBlock_")])
    if n_blocks != len(resnet.blocks):
        raise ValueError(f"{n_blocks} blocks in the source, {len(resnet.blocks)} in the module")
    for i, blk in enumerate(resnet.blocks):
        name = f"BasicBlock_{i}"
        b, st = p[name], stats[name]
        load_conv(blk.conv0, b["Conv_0"], f"{name}.Conv_0")
        load_batch_norm(blk.bn0, b["BatchNorm_0"], st["BatchNorm_0"], f"{name}.BatchNorm_0")
        load_conv(blk.conv1, b["Conv_1"], f"{name}.Conv_1")
        load_batch_norm(blk.bn1, b["BatchNorm_1"], st["BatchNorm_1"], f"{name}.BatchNorm_1")
        if ("downsample" in b) != (blk.downsample is not None):
            raise ValueError(f"{name}: downsample on one side only")
        if blk.downsample is not None:
            load_conv(blk.downsample, b["downsample"], f"{name}.downsample")
            load_batch_norm(blk.downsample_bn, b["downsample_bn"], st["downsample_bn"],
                            f"{name}.downsample_bn")


def load_backbone_params(modules: nn.ModuleDict, p: Tree, batch_stats: Tree) -> None:
    """A rehearsal method's ``{"backbone", "head"}`` tree and its backbone's
    ``batch_stats`` into the port's ``{"backbone", "head"}`` modules."""
    load_resnet(modules["backbone"], p["backbone"], batch_stats)
    load_dense(modules["head"].dense, p["head"]["Dense_0"], "head.Dense_0")


def resnet_state_from_flax(method, params: Tree, mvars: Tree, seed: int = 0):
    """A port ``TrainState`` for a method on a ResNet (Finetune, iCaRL)
    holding the JAX state's weights: ``params`` is ``state.params`` and
    ``mvars`` is ``state.mvars``, both as numpy trees. iCaRL's teacher, class
    means and their flags come along."""
    from libcontinual_tpu_torch.models import get_backbone
    from libcontinual_tpu_torch.models.heads import LinearHead

    state = method.backbone_state(
        get_backbone(method.config), LinearHead(method.feat_dim, method.num_class), seed)
    load_backbone_params(state.params, params, mvars["model_state"]["batch_stats"])
    mv, dev = state.mvars, method.device
    if "teacher" in mv:
        load_backbone_params(mv["teacher"], mvars["teacher"], mvars["teacher_state"]["batch_stats"])
        mv["class_means"] = _tensor(mvars["class_means"]).to(dev)
        mv["mean_valid"] = _tensor(mvars["mean_valid"]).to(dev)
        mv["nme_ready"] = bool(np.asarray(mvars["nme_ready"]) > 0)
    return state


MOE_LEAVES = ("w_gate", "w_noise", "down", "down_b", "up", "up_b")


def load_blocks(blocks: nn.ModuleList, p: Tree) -> None:
    """``block_{i}`` subtrees (LayerNorms, attention, MLP, MoE experts) into
    the port's ``ViTBlock``s."""
    n_blocks = len([k for k in p if k.startswith("block_")])
    if n_blocks != len(blocks):
        raise ValueError(f"{n_blocks} blocks in the source, {len(blocks)} in the module")
    for i, blk in enumerate(blocks):
        b = p[f"block_{i}"]
        load_layer_norm(blk.ln_1, b["ln_1"], f"block_{i}.ln_1")
        load_dense(blk.attn.qkv, b["attn"]["qkv"], f"block_{i}.attn.qkv")
        load_dense(blk.attn.proj, b["attn"]["proj"], f"block_{i}.attn.proj")
        load_layer_norm(blk.ln_2, b["ln_2"], f"block_{i}.ln_2")
        load_dense(blk.mlp.fc1, b["mlp"]["fc1"], f"block_{i}.mlp.fc1")
        load_dense(blk.mlp.fc2, b["mlp"]["fc2"], f"block_{i}.mlp.fc2")
        if ("moe" in b) != (blk.moe is not None):
            raise ValueError(f"block_{i}: MoE experts on one side only")
        if blk.moe is not None:
            for leaf in MOE_LEAVES:
                _put(getattr(blk.moe, leaf), _tensor(b["moe"][leaf]), f"block_{i}.moe.{leaf}")


def load_vit(vit: nn.Module, p: Tree) -> None:
    """A flax ``VisionTransformer`` param tree into a port ``VisionTransformer``."""
    _put(vit.patch_embed.weight, _tensor(p["patch_embed"]["kernel"]).permute(3, 2, 0, 1),
         "patch_embed.kernel")
    _put(vit.patch_embed.bias, _tensor(p["patch_embed"]["bias"]), "patch_embed.bias")
    _put(vit.cls_token, _tensor(p["cls_token"]), "cls_token")
    _put(vit.pos_embed, _tensor(p["pos_embed"]), "pos_embed")
    if ("ln_pre_n" in p) != (vit.ln_pre is not None):
        raise ValueError("ln_pre on one side only")
    if vit.ln_pre is not None:
        load_layer_norm(vit.ln_pre, p["ln_pre_n"], "ln_pre_n")
    load_blocks(vit.blocks, p)
    load_layer_norm(vit.norm, p["norm"], "norm")


def load_clip(clip: nn.Module, p: Tree) -> None:
    """A flax ``CLIP`` param tree into a port ``CLIP``."""
    load_vit(clip.visual, p["visual"])
    t = p["text"]
    text = clip.text
    _put(text.token_embedding, _tensor(t["token_embedding"]), "text.token_embedding")
    _put(text.pos_embed, _tensor(t["pos_embed"]), "text.pos_embed")
    load_blocks(text.blocks, t)
    load_layer_norm(text.ln_final, t["ln_final"], "text.ln_final")
    _put(text.text_projection, _tensor(t["text_projection"]), "text.text_projection")
    _put(clip.visual_projection, _tensor(p["visual_projection"]), "visual_projection")
    _put(clip.logit_scale, _tensor(p["logit_scale"]), "logit_scale")


def merge_trees(a: Tree, b: Tree) -> Tree:
    """``b`` with ``a``'s leaves added (MoE-Adapter4CL's trainable and frozen
    halves into one CLIP tree)."""
    out = dict(b)
    for k, v in a.items():
        out[k] = merge_trees(v, b.get(k, {})) if isinstance(v, dict) else v
    return out


def load_l2p_params(params: nn.ModuleDict, p: Tree) -> None:
    """L2P's trainable tree: ``head.Dense_0`` and ``prompt.{prompt, key}``."""
    load_dense(params["head"].dense, p["head"]["Dense_0"], "head.Dense_0")
    _put(params["prompt"].prompt, _tensor(p["prompt"]["prompt"]), "prompt.prompt")
    _put(params["prompt"].key, _tensor(p["prompt"]["key"]), "prompt.key")


def load_prompt_dict_params(params: nn.ModuleDict, p: Tree) -> None:
    """A trainable tree whose prompts are a flat dict of arrays
    (DualPrompt, CODA-Prompt, DAP) into ``head`` and a ``ParameterDict``."""
    load_dense(params["head"].dense, p["head"]["Dense_0"], "head.Dense_0")
    prompt = params["prompt"]
    if set(prompt.keys()) != set(p["prompt"]):
        raise ValueError(f"prompt names: source {sorted(p['prompt'])} vs module "
                         f"{sorted(prompt.keys())}")
    for name, t in prompt.items():
        _put(t, _tensor(p["prompt"][name]), f"prompt.{name}")


def prompt_state_from_flax(method, params: Tree, frozen: Tree, seed: int = 0):
    """A port ``TrainState`` for a prompt method holding the JAX state's
    weights: ``params`` is ``state.params`` and ``frozen`` is
    ``state.mvars["frozen"]``, both as numpy trees."""
    from libcontinual_tpu_torch.models import get_backbone
    from libcontinual_tpu_torch.models.heads import LinearHead

    vit = get_backbone(method.config)
    load_vit(vit, frozen)
    modules = nn.ModuleDict({
        "head": LinearHead(method.embed_dim, method.num_class),
        "prompt": method.init_prompt_params(None),
    })
    if isinstance(modules["prompt"], nn.ParameterDict):
        load_prompt_dict_params(modules, params)
    else:
        load_l2p_params(modules, params)
    return method.make_state(vit, modules, seed)


def clip_state_from_flax(method, params: Tree, mvars: Tree, seed: int = 0):
    """A port ``TrainState`` for MoE-Adapter4CL or RAPF holding the JAX
    state's weights and method variables: ``params`` is ``state.params`` and
    ``mvars`` is ``state.mvars``, both as numpy trees."""
    from libcontinual_tpu_torch.methods.clip_methods import RAPF
    from libcontinual_tpu_torch.models import get_backbone

    clip = get_backbone(method.config)
    if not isinstance(method, RAPF):  # MoE-Adapter4CL
        load_clip(clip, merge_trees(params["clip"], mvars["frozen"]))
        return method.make_state(clip, seed)
    load_clip(clip, mvars["frozen"])
    state = method.make_state(clip, _tensor(params["adapter"]["kernel"]), seed)
    mv, dev = state.mvars, method.device
    for key in ("text_feats", "cls_mean", "cls_chol", "cls_valid", "hard_valid"):
        mv[key] = _tensor(mvars[key]).to(dev)
    for key in ("replay_order", "hard_old", "hard_new"):
        mv[key] = torch.from_numpy(np.asarray(mvars[key]).astype(np.int64)).to(dev)
    mv["replay_len"] = int(mvars["replay_len"])
    mv["old_adapter"] = {"kernel": _tensor(mvars["old_adapter"]["kernel"]).to(dev)}
    return state
