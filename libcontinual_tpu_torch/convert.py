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
    ``nn.ParameterDict``.

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


def load_vit(vit: nn.Module, p: Tree) -> None:
    """A flax ``VisionTransformer`` param tree into a port ``VisionTransformer``."""
    _put(vit.patch_embed.weight, _tensor(p["patch_embed"]["kernel"]).permute(3, 2, 0, 1),
         "patch_embed.kernel")
    _put(vit.patch_embed.bias, _tensor(p["patch_embed"]["bias"]), "patch_embed.bias")
    _put(vit.cls_token, _tensor(p["cls_token"]), "cls_token")
    _put(vit.pos_embed, _tensor(p["pos_embed"]), "pos_embed")
    n_blocks = len([k for k in p if k.startswith("block_")])
    if n_blocks != len(vit.blocks):
        raise ValueError(f"{n_blocks} blocks in the source, {len(vit.blocks)} in the module")
    for i, blk in enumerate(vit.blocks):
        b = p[f"block_{i}"]
        load_layer_norm(blk.ln_1, b["ln_1"], f"block_{i}.ln_1")
        load_dense(blk.attn.qkv, b["attn"]["qkv"], f"block_{i}.attn.qkv")
        load_dense(blk.attn.proj, b["attn"]["proj"], f"block_{i}.attn.proj")
        load_layer_norm(blk.ln_2, b["ln_2"], f"block_{i}.ln_2")
        load_dense(blk.mlp.fc1, b["mlp"]["fc1"], f"block_{i}.mlp.fc1")
        load_dense(blk.mlp.fc2, b["mlp"]["fc2"], f"block_{i}.mlp.fc2")
    load_layer_norm(vit.norm, p["norm"], "norm")


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
