"""CLIP, the dual-tower contrastive model (``libcontinual_tpu/models/clip.py``).

Both towers are built from the port's ViT block, so MoE-adapter experts work
the same way in the visual and the text stream. ViT-B/16 visual tower by
default (224/16, width 768, embedding 512) and the standard CLIP text tower
(49408 tokens, context 77, width 512, 8 heads). Parameters are kept in f32
and cast to the compute dtype where they are used, as in the JAX package.

The text tower's attention runs under a causal ``-1e30`` mask built in f32,
on the masked-attention kernel; its features are the final LayerNorm (f32)
of the end-of-text token, the largest token id, times ``text_projection``.
Features are normalised as ``x / (||x|| + 1e-8)``.

``load_clip_torch_weights`` reads a local OpenAI state dict; there is no
download.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from libcontinual_tpu_torch.models.vit import ViTBlock, VisionTransformer, layer_norm
from libcontinual_tpu_torch.registry import BACKBONES


def _normal_(t: torch.Tensor, std: float, gen) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 depth: int = 12, num_heads: int = 8, embed_dim: int = 512,
                 moe_experts: int = 0, moe_top_k: int = 2, moe_text_gate: str = "sot",
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        if moe_text_gate not in ("sot", "eot"):
            raise ValueError(f"moe_text_gate must be 'sot' or 'eot', got {moe_text_gate!r}")
        self.dtype, self.moe_experts, self.moe_text_gate = dtype, moe_experts, moe_text_gate
        self.token_embedding = nn.Parameter(torch.zeros(vocab_size, width))
        self.pos_embed = nn.Parameter(torch.zeros(context_length, width))
        self.blocks = nn.ModuleList(
            # OpenAI CLIP's LayerNorm eps is torch's default, 1e-5
            ViTBlock(width, num_heads, dtype=dtype, ln_eps=1e-5, act="quick_gelu",
                     moe_experts=moe_experts, moe_top_k=moe_top_k)
            for _ in range(depth)
        )
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))
        self.reset_parameters(generator)

    def reset_parameters(self, gen=None) -> None:
        _normal_(self.token_embedding, 0.02, gen)
        _normal_(self.pos_embed, 0.01, gen)
        for blk in self.blocks:
            blk.reset_parameters(gen)
        self.ln_final.reset_parameters()
        _normal_(self.text_projection, 0.02, gen)

    def forward(self, tokens: torch.Tensor, moe_gen: Optional[torch.Generator] = None):
        dt = self.dtype
        s = tokens.shape[1]
        x = self.token_embedding[tokens].to(dt) + self.pos_embed[None, :s].to(dt)
        causal = torch.triu(
            torch.full((s, s), -1e30, dtype=torch.float32, device=tokens.device), diagonal=1
        )
        eot_pos = tokens.argmax(dim=-1)
        # "sot" routes on token 0, which under the causal mask sees only
        # itself; "eot" routes each prompt on its end-of-text token
        gate_pos = eot_pos if self.moe_text_gate == "eot" else None
        moe_aux = 0.0
        for blk in self.blocks:
            if self.moe_experts > 0:
                x, aux = blk(x, attn_mask=causal, gate_pos=gate_pos, moe_gen=moe_gen)
                moe_aux = moe_aux + aux
            else:
                x = blk(x, attn_mask=causal)
        x = layer_norm(self.ln_final, x, torch.float32)
        feats = x[torch.arange(x.shape[0], device=x.device), eot_pos]
        out = {"features": feats @ self.text_projection}
        if self.moe_experts > 0:
            out["moe_aux"] = moe_aux
        return out


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class CLIP(nn.Module):
    """Dual towers and a logit scale; ``forward(images, tokens)`` returns the
    normalised features and the contrastive logits."""

    def __init__(self, embed_dim: int = 512, image_size: int = 224, vision_width: int = 768,
                 vision_depth: int = 12, vision_heads: int = 12, patch_size: int = 16,
                 text_width: int = 512, text_depth: int = 12, text_heads: int = 8,
                 moe_experts: int = 0, moe_top_k: int = 2, moe_text_gate: str = "sot",
                 dtype=torch.bfloat16, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.visual = VisionTransformer(
            img_size=image_size, patch_size=patch_size, embed_dim=vision_width,
            depth=vision_depth, num_heads=vision_heads, dtype=dtype,
            block_ln_eps=1e-5, final_ln_eps=1e-5,  # ln_post
            generator=generator, ln_pre=True, act="quick_gelu",
            moe_experts=moe_experts, moe_top_k=moe_top_k,
        )
        self.text = TextTransformer(
            width=text_width, depth=text_depth, num_heads=text_heads, embed_dim=embed_dim,
            moe_experts=moe_experts, moe_top_k=moe_top_k, moe_text_gate=moe_text_gate,
            dtype=dtype, generator=generator,
        )
        self.visual_projection = nn.Parameter(torch.zeros(vision_width, embed_dim))
        _normal_(self.visual_projection, 0.02, generator)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07), dtype=torch.float32))

    def encode_image(self, images: torch.Tensor, moe_gen: Optional[torch.Generator] = None):
        out = self.visual(images, moe_gen=moe_gen)
        return out["features"] @ self.visual_projection, out

    def encode_text(self, tokens: torch.Tensor, moe_gen: Optional[torch.Generator] = None):
        out = self.text(tokens, moe_gen=moe_gen)
        return out["features"], out

    def forward(self, images, tokens, moe_gen: Optional[torch.Generator] = None):
        img_f, v_out = self.encode_image(images, moe_gen)
        txt_f, t_out = self.encode_text(tokens, moe_gen)
        img_n, txt_n = _unit(img_f), _unit(txt_f)
        logits = torch.exp(self.logit_scale) * img_n @ txt_n.T
        return {
            "image_features": img_n,
            "text_features": txt_n,
            "logits_per_image": logits,
            "logits_per_text": logits.T,
            "moe_aux": v_out.get("moe_aux", 0.0) + t_out.get("moe_aux", 0.0),
        }


# ----------------------------------------------------------- weight import


def _copy(dst: torch.Tensor, value) -> None:
    with torch.no_grad():
        dst.copy_(torch.as_tensor(np.asarray(value, dtype=np.float32)).reshape(dst.shape))


def load_clip_torch_weights(model: CLIP, source: Union[str, Mapping[str, Any]]) -> CLIP:
    """Load an OpenAI-CLIP state dict into ``model`` in place: ``source`` is
    the path of a local torch checkpoint (read with ``weights_only=True``) or
    a mapping of arrays. The key map is the JAX package's; keys that are
    missing, and projections of another shape, leave the model's values."""
    if isinstance(source, str):
        if not os.path.exists(source):
            raise FileNotFoundError(source)
        source = torch.load(source, map_location="cpu", weights_only=True)
    sd: Dict[str, np.ndarray] = {
        k: (v.detach().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in source.items()
    }
    vis, txt = model.visual, model.text

    def put(dst, key):
        if key in sd:
            _copy(dst, sd[key])

    if "visual.proj" in sd and tuple(model.visual_projection.shape) == sd["visual.proj"].shape:
        _copy(model.visual_projection, sd["visual.proj"])
    if ("text_projection" in sd
            and tuple(txt.text_projection.shape) == sd["text_projection"].shape):
        _copy(txt.text_projection, sd["text_projection"])
    put(model.logit_scale, "logit_scale")
    put(txt.token_embedding, "token_embedding.weight")
    put(txt.pos_embed, "positional_embedding")
    put(txt.ln_final.weight, "ln_final.weight")
    put(txt.ln_final.bias, "ln_final.bias")
    put(vis.patch_embed.weight, "visual.conv1.weight")  # (out, in, kh, kw) both sides
    put(vis.cls_token, "visual.class_embedding")
    put(vis.pos_embed, "visual.positional_embedding")
    if vis.ln_pre is not None:
        put(vis.ln_pre.weight, "visual.ln_pre.weight")
        put(vis.ln_pre.bias, "visual.ln_pre.bias")
    put(vis.norm.weight, "visual.ln_post.weight")
    put(vis.norm.bias, "visual.ln_post.bias")

    def load_block(blk, prefix):
        for ours, theirs in ((blk.ln_1, "ln_1"), (blk.ln_2, "ln_2")):
            put(ours.weight, f"{prefix}.{theirs}.weight")
            put(ours.bias, f"{prefix}.{theirs}.bias")
        put(blk.attn.qkv.weight, f"{prefix}.attn.in_proj_weight")
        put(blk.attn.qkv.bias, f"{prefix}.attn.in_proj_bias")
        put(blk.attn.proj.weight, f"{prefix}.attn.out_proj.weight")
        put(blk.attn.proj.bias, f"{prefix}.attn.out_proj.bias")
        put(blk.mlp.fc1.weight, f"{prefix}.mlp.c_fc.weight")
        put(blk.mlp.fc1.bias, f"{prefix}.mlp.c_fc.bias")
        put(blk.mlp.fc2.weight, f"{prefix}.mlp.c_proj.weight")
        put(blk.mlp.fc2.bias, f"{prefix}.mlp.c_proj.bias")

    for i, blk in enumerate(vis.blocks):
        load_block(blk, f"visual.transformer.resblocks.{i}")
    for i, blk in enumerate(txt.blocks):
        load_block(blk, f"transformer.resblocks.{i}")
    return model


def _no_adapter(kwargs) -> None:
    if int(kwargs.get("adapter_dim", 0) or 0):
        raise NotImplementedError(
            "adapter_dim > 0 (the adaptmlp adapters) is not in the PyTorch port yet"
        )


@BACKBONES.register("clip", aliases=("Clip", "CLIP"))
def clip(**kwargs):
    _no_adapter(kwargs)
    return CLIP(
        image_size=int(kwargs.get("img_size", kwargs.get("image_size", 224))),
        moe_experts=int(kwargs.get("moe_experts", kwargs.get("experts_num", 0)) or 0),
        moe_top_k=int(kwargs.get("moe_top_k", kwargs.get("top_k", 2))),
        moe_text_gate=str(kwargs.get("moe_text_gate", "sot")),
        dtype=kwargs.get("dtype", torch.bfloat16),
        generator=kwargs.get("generator"),
    )


@BACKBONES.register("clip_tiny_test")
def clip_tiny_test(**kwargs):
    """Small CLIP for unit tests (32px/patch 8, 2+2 blocks, dim 64)."""
    _no_adapter(kwargs)
    return CLIP(
        embed_dim=32, image_size=32, vision_width=64, vision_depth=2, vision_heads=4,
        patch_size=8, text_width=64, text_depth=2, text_heads=4,
        moe_experts=int(kwargs.get("moe_experts", 0)),
        moe_top_k=int(kwargs.get("moe_top_k", kwargs.get("top_k", 2))),
        moe_text_gate=str(kwargs.get("moe_text_gate", "sot")),
        dtype=kwargs.get("dtype", torch.float32),
        generator=kwargs.get("generator"),
    )
