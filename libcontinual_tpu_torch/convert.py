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
