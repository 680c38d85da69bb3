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
  * a ResNet's ``conv_stem`` / ``bn_stem`` and ``BasicBlock_{i}`` /
    ``Bottleneck_{i}`` subtrees (``Conv_{j}``, ``BatchNorm_{j}`` and, where
    the shapes change, ``downsample`` / ``downsample_bn``), the
    pre-activation ResNet's ``PreActBasicBlock_{i}`` (a bare ``downsample``
    conv) and ``bn_final``, CBAM's ``Conv_0`` / ``BatchNorm_0`` stem and
    ``CBAMBasicBlock_{i}`` (``ChannelGate_0``'s two Dense layers,
    ``SpatialGate_0``, the ``Conv_2`` / ``BatchNorm_2`` shortcut), TinyCNN's
    two conv / BatchNorm pairs; the BatchNorm ``scale`` / ``bias`` with the
    ``batch_stats`` ``mean`` / ``var`` as the running buffers;
  * the ResNet methods' ``{"backbone", "head"}`` tree (``head`` a Dense,
    LUCIR's cosine ``kernel`` and ``sigma`` or ER's cosine ``kernel``; DER's
    ``backbone`` leaves stacked on a leading ``task_num`` axis, one slice per
    extractor, and its ``aux`` head; PRAKA's ``single`` head; OCM's ``proj``
    Dense) and their ``mvars`` (:func:`resnet_state_from_flax`);
  * AlexNet's ``conv{i}_kernel`` (HWIO -> OIHW) and ``fc{i}_kernel``
    (``(in, out)`` -> ``(out, in)``), ``bn{i}`` ``scale`` / ``bias`` and API's
    ``ws{i}`` slabs; GPM's, TRGP's and API's bias-less head, TRGP's
    ``tr_scale``, their ``mvars`` (``proj``, ``tr_space``, ``proj_sign``,
    ``old_rows``, ``ws_mask``) and their host-side state (``_feature_list``,
    ``_task_spaces``, ``_project_type``, ``_ws_counts``); DMNSP's adapters
    (``adaptmlp`` ``down`` / ``up`` Dense -> Linear) in the ViT's blocks with
    its ``basis``, ``basis_n``, ``P``, ``lam`` and ``proj_on``
    (:func:`load_gradproj_state`);
  * the CLIP tree (both towers, ``ln_pre_n``, ``token_embedding``,
    ``pos_embed``, both projections, ``logit_scale``) and the MoE leaves
    (``w_gate``, ``w_noise``, ``down``, ``down_b``, ``up``, ``up_b``) as they
    are; MoE-Adapter4CL's ``params["clip"]`` merged with its
    ``mvars["frozen"]``; RAPF's adapter kernel and its ``mvars``.

Values are copied into the modules' existing tensors, so each module keeps
its own dtype and device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

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
    if ("bias" in p) != (lin.bias is not None):
        raise ValueError(f"{name}: bias on one side only")
    if lin.bias is not None:
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


def _load_bn_pair(conv, bn, p: Tree, stats: Tree, conv_name: str, bn_name: str,
                  prefix: str) -> None:
    load_conv(conv, p[conv_name], f"{prefix}.{conv_name}")
    load_batch_norm(bn, p[bn_name], stats[bn_name], f"{prefix}.{bn_name}")


def _load_downsample(blk, b: Tree, st: Tree, name: str, conv_name: str = "downsample",
                     bn_name: Optional[str] = "downsample_bn") -> None:
    if (conv_name in b) != (blk.downsample is not None):
        raise ValueError(f"{name}: downsample on one side only")
    if blk.downsample is None:
        return
    load_conv(blk.downsample, b[conv_name], f"{name}.{conv_name}")
    if bn_name is not None:
        load_batch_norm(blk.downsample_bn, b[bn_name], st[bn_name], f"{name}.{bn_name}")


def _load_block(blk, b: Tree, st: Tree, name: str) -> None:
    """One ``BasicBlock`` / ``Bottleneck`` / ``PreActBasicBlock`` /
    ``CBAMBasicBlock`` subtree."""
    from libcontinual_tpu_torch.models.cbam import CBAMBasicBlock
    from libcontinual_tpu_torch.models.resnet import PreActBasicBlock

    n_conv = 3 if hasattr(blk, "conv2") else 2
    for i in range(n_conv):
        _load_bn_pair(getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}"), b, st, f"Conv_{i}",
                      f"BatchNorm_{i}", name)
    if isinstance(blk, PreActBasicBlock):  # a bare conv shortcut
        _load_downsample(blk, b, st, name, bn_name=None)
    elif isinstance(blk, CBAMBasicBlock):
        gate = b["ChannelGate_0"]
        load_dense(blk.channel_gate.fc0, gate["Dense_0"], f"{name}.ChannelGate_0.Dense_0")
        load_dense(blk.channel_gate.fc1, gate["Dense_1"], f"{name}.ChannelGate_0.Dense_1")
        _load_bn_pair(blk.spatial_gate.conv, blk.spatial_gate.bn, b["SpatialGate_0"],
                      st["SpatialGate_0"], "Conv_0", "BatchNorm_0", f"{name}.SpatialGate_0")
        _load_downsample(blk, b, st, name, "Conv_2", "BatchNorm_2")
    else:
        _load_downsample(blk, b, st, name)


def load_resnet(resnet: nn.Module, p: Tree, stats: Tree) -> None:
    """A flax ``ResNet`` / ``CifarResNet`` / ``PreActCifarResNet`` /
    ``CBAMResNet`` / ``TinyCNN`` (``params`` and ``batch_stats``) into the
    port's module of the same name."""
    from libcontinual_tpu_torch.models.cbam import CBAMResNet
    from libcontinual_tpu_torch.models.resnet import PreActCifarResNet, TinyCNN

    if isinstance(resnet, TinyCNN):
        for i in range(2):
            _load_bn_pair(getattr(resnet, f"conv{i}"), getattr(resnet, f"bn{i}"), p, stats,
                          f"Conv_{i}", f"BatchNorm_{i}", "TinyCNN")
        return
    if isinstance(resnet, CBAMResNet):
        _load_bn_pair(resnet.conv_stem, resnet.bn_stem, p, stats, "Conv_0", "BatchNorm_0", "stem")
        prefix = "CBAMBasicBlock_"
    elif isinstance(resnet, PreActCifarResNet):
        load_conv(resnet.conv_stem, p["conv_stem"], "conv_stem")
        load_batch_norm(resnet.bn_final, p["bn_final"], stats["bn_final"], "bn_final")
        prefix = "PreActBasicBlock_"
    else:
        _load_bn_pair(resnet.conv_stem, resnet.bn_stem, p, stats, "conv_stem", "bn_stem", "stem")
        prefix = "Bottleneck_" if hasattr(resnet.blocks[0], "conv2") else "BasicBlock_"
    n_blocks = len([k for k in p if k.startswith(prefix)])
    if n_blocks != len(resnet.blocks):
        raise ValueError(f"{n_blocks} blocks in the source, {len(resnet.blocks)} in the module")
    for i, blk in enumerate(resnet.blocks):
        _load_block(blk, p[f"{prefix}{i}"], stats[f"{prefix}{i}"], f"{prefix}{i}")


def load_head(head: nn.Module, p: Tree, name: str = "head") -> None:
    """A ``LinearHead`` (``Dense_0``), a ``CosineLinear`` (``kernel``,
    ``sigma``) or a ``DistLinear`` (``kernel``)."""
    if "Dense_0" in p:
        load_dense(head.dense, p["Dense_0"], f"{name}.Dense_0")
        return
    _put(head.weight, _tensor(p["kernel"]).T, f"{name}.kernel")
    if ("sigma" in p) != hasattr(head, "sigma"):
        raise ValueError(f"{name}: sigma on one side only")
    if "sigma" in p:
        _put(head.sigma, _tensor(p["sigma"]), f"{name}.sigma")


def _task_slice(tree: Tree, i: int) -> Tree:
    """Entry ``i`` of every leaf of a stacked tree (DER's extractors)."""
    return {k: _task_slice(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def load_backbone_params(modules: nn.ModuleDict, p: Tree, batch_stats: Tree) -> None:
    """A ResNet method's ``{"backbone", "head"[, "aux" | "single" |
    "proj"]}`` tree and its backbone's ``batch_stats`` into the port's
    modules; a ``ModuleList`` of backbones (DER) takes a tree whose leaves
    stack the extractors on a leading axis."""
    bb = modules["backbone"]
    if isinstance(bb, nn.ModuleList):
        for i, m in enumerate(bb):
            load_resnet(m, _task_slice(p["backbone"], i), _task_slice(batch_stats, i))
    else:
        load_resnet(bb, p["backbone"], batch_stats)
    for name in ("head", "aux", "single"):
        if name in modules:
            load_head(modules[name], p[name], name)
    if "proj" in modules:
        load_dense(modules["proj"], p["proj"], "proj")


def named_like(params: nn.ModuleDict, tree: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """A flax-shaped tree of per-parameter values (EWC's Fisher and
    reference parameters) as a dict keyed by the port's parameter names."""
    scratch = copy.deepcopy(params)
    load_backbone_params(scratch, tree, batch_stats)
    return {n: t.detach() for n, t in scratch.named_parameters()}


def load_method_state(method, state, params: Tree, mvars: Tree) -> None:
    """The JAX state of a method on a ResNet into an existing port state, in
    place (the optimizer keeps its ``Parameter`` objects and its momentum):
    ``params`` is ``state.params`` and ``mvars`` is ``state.mvars``, both as
    numpy trees. What a method keeps in ``mvars`` comes along: iCaRL's
    teacher, class means and their flags, the teachers of LwF, WA, LUCIR and
    BiC, EWC's Fisher and reference parameters, BiC's alphas, betas and
    decay, LUCIR's ``cur_lamda`` and ``head_col_mask``, DER's active
    count (a new count rebuilds the optimizer over the newest extractor),
    the replay slabs of ER-ACE, ER-AML and OCM with their ``n_seen``,
    ER's ``seen_so_far``, the teachers of OCM and PRAKA (their ``proj`` and
    ``single`` heads included) and PRAKA's prototypes and their flags."""
    stats = mvars["model_state"]["batch_stats"]
    load_backbone_params(state.params, params, stats)
    mv, dev = state.mvars, method.device
    if "teacher" in mv:
        load_backbone_params(mv["teacher"], mvars["teacher"], mvars["teacher_state"]["batch_stats"])
    if "class_means" in mv:
        mv["class_means"] = _tensor(mvars["class_means"]).to(dev)
        mv["mean_valid"] = _tensor(mvars["mean_valid"]).to(dev)
        mv["nme_ready"] = bool(np.asarray(mvars["nme_ready"]) > 0)
    for key in ("fisher", "ref_params"):
        if key in mv:
            mv[key] = {k: v.to(dev) for k, v in
                       named_like(state.params, mvars[key], stats).items()}
    if "buffer" in mv:
        buf = mvars["buffer"]
        mv["buffer"] = {
            "bx": torch.from_numpy(np.array(buf["bx"], dtype=np.uint8)).to(dev),
            **{k: torch.from_numpy(np.array(buf[k], dtype=np.int64)).to(dev)
               for k in ("by", "bt", "n_seen")}}
    if "seen_so_far" in mv:
        mv["seen_so_far"] = int(np.asarray(mvars["seen_so_far"]))
    for key in ("alphas", "betas", "head_col_mask", "protos", "proto_valid"):
        if key in mv:
            mv[key] = _tensor(mvars[key]).to(dev)
    for key in ("wd", "cur_lamda"):
        if key in mv:
            mv[key] = float(np.asarray(mvars[key]))
    if "n_active" in mv:
        n = int(np.asarray(mvars["active"]).sum())
        if n != mv["n_active"]:
            mv["n_active"] = n
            state.opt_state = method._tx_for_task(state.task, method.trainable_parameters(state))


def resnet_state_from_flax(method, params: Tree, mvars: Tree, seed: int = 0):
    """A port ``TrainState`` for a method on a ResNet holding the JAX state's
    weights and method variables (:func:`load_method_state`)."""
    state = method.init_state(seed, (8, 8, 3))
    load_method_state(method, state, params, mvars)
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
        if ("adaptmlp" in b) != (blk.adaptmlp is not None):
            raise ValueError(f"block_{i}: adapter on one side only")
        if blk.adaptmlp is not None:
            for part in ("down", "up"):
                load_dense(getattr(blk.adaptmlp, part), b["adaptmlp"][part],
                           f"block_{i}.adaptmlp.{part}")
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


# ------------------------------------------------------- gradient projection

#: the host-side state of GPM, TRGP and API (attributes of the method)
HOST_ATTRS = ("_feature_list", "_task_spaces", "_project_type", "_ws_counts")


def load_alexnet(net: nn.Module, p: Tree) -> None:
    """A flax ``AlexNetTRGP`` / ``AlexNetAPI`` param tree into the port's."""
    for i in range(3):
        _put(getattr(net, f"conv{i}"), _tensor(p[f"conv{i}_kernel"]).permute(3, 2, 0, 1),
             f"conv{i}_kernel")
    for i in (3, 4):
        _put(getattr(net, f"fc{i}"), _tensor(p[f"fc{i}_kernel"]).T, f"fc{i}_kernel")
    for i in range(5):
        bn = getattr(net, f"bn{i}")
        _put(bn.weight, _tensor(p[f"bn{i}"]["scale"]), f"bn{i}.scale")
        _put(bn.bias, _tensor(p[f"bn{i}"]["bias"]), f"bn{i}.bias")
    if ("ws0" in p) != hasattr(net, "ws0"):
        raise ValueError("API's ws slabs on one side only")
    for i in range(5 if "ws0" in p else 0):
        _put(getattr(net, f"ws{i}"), _tensor(p[f"ws{i}"]), f"ws{i}")


def _tensors(arrays, dev):
    return [_tensor(a).to(dev) for a in arrays]


def load_host_state(method, host: Dict[str, Any]) -> None:
    """A method's host-side state (:data:`HOST_ATTRS`, as numpy): the bases
    become float64 tensors on the method's device."""
    dev = method.device
    f64 = (lambda a: torch.from_numpy(np.array(a, dtype=np.float64)).to(dev))
    if "_feature_list" in host:
        method._feature_list = [f64(u) for u in host["_feature_list"]]
    if "_task_spaces" in host:
        method._task_spaces = [[f64(u) for u in task] for task in host["_task_spaces"]]
    if "_project_type" in host:
        method._project_type = list(host["_project_type"])
    if "_ws_counts" in host:
        method._ws_counts = np.array(host["_ws_counts"], dtype=np.int64)


def load_gradproj_params(modules: nn.ModuleDict, p: Tree) -> None:
    """GPM's, TRGP's, API's or DMNSP's trainable tree (``state.params``, or a
    tree of the same shape such as its gradients) into the port's trainable
    modules."""
    load_dense(modules["head"].dense, p["head"]["Dense_0"], "head.Dense_0")
    if "adapters" in p:
        for blk, adapter in p["adapters"].items():
            for part in ("down", "up"):
                load_dense(getattr(modules["adapters"][blk], part), adapter[part],
                           f"adapters.{blk}.{part}")
        return
    load_alexnet(modules["backbone"], p["backbone"])
    if "tr_scale" in p:
        for li, t in enumerate(p["tr_scale"]):
            _put(modules["tr_scale"][li], _tensor(t), f"tr_scale[{li}]")


def load_gradproj_state(method, state, params: Tree, mvars: Tree,
                        host: Optional[Dict[str, Any]] = None) -> None:
    """The JAX state of GPM, TRGP, API (on AlexNet) or DMNSP (on the adapter
    ViT) into an existing port state, in place: ``params`` is
    ``state.params`` and ``mvars`` is ``state.mvars``, both as numpy trees,
    and ``host`` the method's host-side state (:data:`HOST_ATTRS`)."""
    mv, dev = state.mvars, method.device
    if "adapters" in params:  # DMNSP
        full = {k: dict(v) if isinstance(v, dict) else v for k, v in mvars["frozen"].items()}
        for blk, adapter in params["adapters"].items():
            full[blk]["adaptmlp"] = adapter
        load_vit(mv["frozen"], full)
        load_dense(state.params["head"].dense, params["head"]["Dense_0"], "head.Dense_0")
        mv["basis"], mv["P"], mv["lam"] = (_tensor(mvars[k]).to(dev) for k in ("basis", "P", "lam"))
        mv["basis_n"] = [int(n) for n in np.asarray(mvars["basis_n"])]
        mv["proj_on"] = bool(np.asarray(mvars["proj_on"]) > 0)
        return
    load_gradproj_params(state.params, params)
    for key in ("proj", "tr_space", "old_rows", "ws_mask"):
        if key in mvars:
            mv[key] = _tensors(mvars[key], dev)
    if "proj_sign" in mvars:
        mv["proj_sign"] = _tensor(mvars["proj_sign"]).to(dev)
    if "bn_trainable" in mvars:
        mv["bn_trainable"] = bool(np.asarray(mvars["bn_trainable"]) > 0)
    load_host_state(method, host or {})


def gradproj_state_from_flax(method, params: Tree, mvars: Tree,
                             host: Optional[Dict[str, Any]] = None, seed: int = 0):
    """A port ``TrainState`` for GPM, TRGP, API or DMNSP holding the JAX
    state's weights, method variables and host-side state
    (:func:`load_gradproj_state`)."""
    state = method.init_state(seed, (32, 32, 3))
    load_gradproj_state(method, state, params, mvars, host)
    return state
