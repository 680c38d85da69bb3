"""Vision Transformer for the prompt family and the CLIP towers
(``libcontinual_tpu/models/vit.py``).

What the prompt family needs: the pure self-attention block,
``prepend_tokens`` (prompt tokens in front of [cls; patches] at layer 0: L2P,
DAP), ``prefix_kv`` (per-block prompt keys and values in front of each
head's keys: DualPrompt, CODA-Prompt) and ``feature_mode="prompt_mean"``.
What the CLIP towers add: ``attn_mask`` (the text tower's causal mask),
QuickGELU, the ``ln_pre`` stem norm and the mixture-of-adapter-experts MLP
(``MoEMLP``, MoE-Adapter4CL) with its per-image routing. What DMNSP adds:
the parallel bottleneck ``Adapter`` (``adapter_dim``) beside each block's
MLP, and ``capture``, which returns each block's attention input ``ln_1(x)``
or the adapter's input, the raw post-attention residual, in f32.

Rounding points are the JAX package's: a residual stream in the compute
dtype (bf16 on the card), LayerNorm statistics and arithmetic in f32 with
the result rounded to the compute dtype, the MLP's GELU in its tanh form at
bf16 and exact erf at f32, and the final norm in f32. The linear
projections and the patch-embed convolution are ``torch.nn.functional``
calls, as the JAX package leaves them to XLA; LayerNorm is the op of
:mod:`libcontinual_tpu_torch.ops.layer_norm` (on the card one kernel that
reads and writes the compute dtype, where XLA fuses the casts); attention
is the packed-qkv kernel of :mod:`libcontinual_tpu_torch.ops.attention`, in a block with a
prefix the prefix-KV kernel of :mod:`libcontinual_tpu_torch.ops.prefix_attention`,
and with a 2-D mask the masked kernel of
:mod:`libcontinual_tpu_torch.ops.masked_attention`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from libcontinual_tpu_torch.ops.attention import fused_qkv_attention
from libcontinual_tpu_torch.ops.layer_norm import layer_norm as layer_norm_op
from libcontinual_tpu_torch.ops.masked_attention import fused_masked_qkv_attention
from libcontinual_tpu_torch.ops.prefix_attention import fused_prefix_attention
from libcontinual_tpu_torch.registry import BACKBONES


# ------------------------------------------------------------ initializers


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: Optional[torch.Generator]) -> None:
    """flax ``lecun_normal``: a normal truncated at two deviations, rescaled so
    the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def trunc_normal_02_(w: torch.Tensor, gen: Optional[torch.Generator]) -> None:
    """flax ``truncated_normal(0.02)``: N(0, 0.02) truncated at +-0.04."""
    nn.init.trunc_normal_(w, 0.0, 0.02, -0.04, 0.04, generator=gen)


def _init_dense(lin: nn.Linear, gen) -> None:
    with torch.no_grad():
        lecun_normal_(lin.weight, lin.in_features, gen)
        lin.bias.zero_()


# ------------------------------------------------------------------ blocks


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: computed in f32, result in ``dtype``."""
    return layer_norm_op(x, ln.weight, ln.bias, ln.eps, dtype)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.bfloat16, act: str = "gelu"):
        super().__init__()
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.dtype, self.act = dtype, act
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def reset_parameters(self, gen=None) -> None:
        _init_dense(self.fc1, gen)
        _init_dense(self.fc2, gen)

    def forward(self, x):
        x = dense(self.fc1, x, self.dtype)
        if self.act == "quick_gelu":
            # OpenAI CLIP's QuickGELU, x * sigmoid(1.702 x)
            x = x * torch.sigmoid(1.702 * x)
        else:
            # tanh GELU at bf16 (equal to erf GELU at bf16 resolution), erf at f32
            x = F.gelu(x, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        return dense(self.fc2, x, self.dtype)


class Adapter(nn.Module):
    """Parallel bottleneck adapter: ``scale * up(dropout(relu(down(x))))``,
    added to the MLP's output. ``down`` is drawn from flax
    ``kaiming_uniform``, ``up`` starts at zero. The bottleneck dropout
    (``dropout_rate``) takes its keep mask as an input (``keep``, booleans
    shaped as the bottleneck activation); without it nothing is dropped."""

    def __init__(self, dim: int, bottleneck: int, scale: float = 0.1, dtype=torch.bfloat16,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.scale, self.dtype, self.dropout_rate = scale, dtype, dropout_rate
        self.down = nn.Linear(dim, bottleneck)
        self.up = nn.Linear(bottleneck, dim)

    def reset_parameters(self, gen=None) -> None:
        limit = math.sqrt(6.0 / self.down.in_features)
        with torch.no_grad():
            self.down.weight.uniform_(-limit, limit, generator=gen)
            for p in (self.down.bias, self.up.weight, self.up.bias):
                p.zero_()

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        h = torch.relu(dense(self.down, x, self.dtype))
        if keep is not None and self.dropout_rate > 0.0:
            h = h * keep.to(h.dtype) / (1.0 - self.dropout_rate)
        return dense(self.up, h, self.dtype) * self.scale


Prefix = Tuple[torch.Tensor, torch.Tensor]  # (pk, pv), each (B, P, D)


class ViTAttention(nn.Module):
    """Packed qkv projection, the fused kernel, proj. With a prefix, the
    prompt keys and values join each head's keys (``fused_prefix_attention``);
    with a 2-D additive mask, the mask is added to every head's scores
    (``fused_masked_qkv_attention``)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)  # output columns [q | k | v]
        self.proj = nn.Linear(dim, dim)

    def reset_parameters(self, gen=None) -> None:
        _init_dense(self.qkv, gen)
        _init_dense(self.proj, gen)

    def forward(self, x, prefix_kv: Optional[Prefix] = None,
                attn_mask: Optional[torch.Tensor] = None):
        qkv = dense(self.qkv, x, self.dtype)
        scale = 1.0 / math.sqrt(self.dim // self.num_heads)
        if attn_mask is not None:
            if prefix_kv is not None or attn_mask.dim() != 2:
                raise NotImplementedError(
                    "attn_mask takes a 2-D (S, S) mask and no prefix_kv in the PyTorch port"
                )
            o = fused_masked_qkv_attention(qkv, attn_mask, scale, self.num_heads)
        elif prefix_kv is None:
            o = fused_qkv_attention(qkv, scale, self.num_heads)
        else:
            pk, pv = prefix_kv
            # The cast makes a broadcast (batch stride 0) prompt dense when it
            # changes the dtype, as in the bf16 step. That keeps the gradient's
            # sum over the batch in the prompt's own dtype (f32), as in the JAX
            # package; a cast before the broadcast would sum in bf16.
            o = fused_prefix_attention(
                qkv, pk.to(self.dtype), pv.to(self.dtype), scale, self.num_heads
            )
        return dense(self.proj, o, self.dtype)


def top_k_gates(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Dense (B, E) gates: a softmax over each row's k largest logits,
    scattered back, zero elsewhere. Ties go to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none): at zero-init
    routers every logit is 0."""
    topi = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    gk = torch.softmax(logits.gather(-1, topi), dim=-1)
    return torch.zeros_like(logits).scatter(-1, topi, gk)


class MoEMLP(nn.Module):
    """Mixture of bottleneck adapter experts beside the MLP (``MoEMLP`` of
    the JAX package; MoE-Adapter4CL): each image is routed once, on its
    ``gate_vec`` (the post-attention CLS or EOT token), to its top-k experts;
    the experts run densely and the gates mix them. Returns the output and
    the cv^2 load-balancing term.

    Training draws are inputs: ``noise`` (B, E) standard normals for the
    noisy gating, ``keep`` (B, S, E, bottleneck) booleans for the experts'
    dropout (kept with probability 1 - ``dropout_rate``). Without them the
    gating is clean and nothing is dropped, as in evaluation."""

    def __init__(self, dim: int, num_experts: int = 4, top_k: int = 2, bottleneck: int = 64,
                 scale: float = 0.1, dropout_rate: float = 0.1, dtype=torch.bfloat16):
        super().__init__()
        self.num_experts, self.top_k, self.bottleneck = num_experts, top_k, bottleneck
        self.scale, self.dropout_rate, self.dtype = scale, dropout_rate, dtype
        e, k = num_experts, bottleneck
        self.w_gate = nn.Parameter(torch.zeros(dim, e))
        self.w_noise = nn.Parameter(torch.zeros(dim, e))
        self.down = nn.Parameter(torch.zeros(e, dim, k))
        self.down_b = nn.Parameter(torch.zeros(e, k))
        self.up = nn.Parameter(torch.zeros(e, k, dim))
        self.up_b = nn.Parameter(torch.zeros(e, dim))

    def reset_parameters(self, gen=None) -> None:
        """flax ``kaiming_uniform`` on ``down`` (fan-in dim x experts: flax
        counts the expert axis as a receptive field); zeros elsewhere."""
        bound = math.sqrt(6.0 / (self.down.shape[0] * self.down.shape[1]))
        with torch.no_grad():
            for p in (self.w_gate, self.w_noise, self.down_b, self.up, self.up_b):
                p.zero_()
            self.down.uniform_(-bound, bound, generator=gen)

    def draws(self, x: torch.Tensor, gen: torch.Generator):
        """Noise and dropout keep-mask for one forward on ``x``, from ``gen``."""
        b, s, _ = x.shape
        noise = torch.randn((b, self.num_experts), generator=gen, device=x.device)
        u = torch.rand((b, s, self.num_experts, self.bottleneck), generator=gen, device=x.device)
        return noise, u < 1.0 - self.dropout_rate

    def forward(self, x, gate_vec: torch.Tensor, noise: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None):
        dt = self.dtype
        gx = gate_vec.float()
        logits = gx @ self.w_gate
        if noise is not None:
            noise_std = F.softplus(gx @ self.w_noise) + 1e-2
            logits = logits + noise * noise_std
        gates = top_k_gates(logits, min(self.top_k, self.num_experts))  # (B, E)
        h = torch.einsum("bsd,edk->bsek", x.to(dt), self.down.to(dt))
        h = torch.relu(h + self.down_b.to(dt)[None, None])
        if keep is not None and self.dropout_rate > 0.0:
            h = torch.where(keep, h / (1.0 - self.dropout_rate), 0.0).to(dt)
        y = torch.einsum("bsek,ekd->bsed", h, self.up.to(dt))
        y = (y + self.up_b.to(dt)[None, None]) * self.scale
        out = torch.einsum("be,bsed->bsd", gates.to(dt), y)
        importance = gates.sum(dim=0)
        cv2 = importance.var(correction=0) / (importance.mean() ** 2 + 1e-10)
        return out, cv2


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, dtype=torch.bfloat16, ln_eps=1e-6,
                 act: str = "gelu", moe_experts: int = 0, moe_top_k: int = 2,
                 adapter_dim: int = 0, adapter_scale: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = ViTAttention(dim, num_heads, dtype)
        self.ln_2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dtype, act)
        self.adaptmlp = (Adapter(dim, adapter_dim, adapter_scale, dtype)
                         if adapter_dim > 0 else None)
        self.moe = MoEMLP(dim, moe_experts, moe_top_k, dtype=dtype) if moe_experts > 0 else None

    def reset_parameters(self, gen=None) -> None:
        self.ln_1.reset_parameters()
        self.ln_2.reset_parameters()
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)
        if self.adaptmlp is not None:
            self.adaptmlp.reset_parameters(gen)
        if self.moe is not None:
            self.moe.reset_parameters(gen)

    def forward(self, x, prefix_kv: Optional[Prefix] = None,
                attn_mask: Optional[torch.Tensor] = None,
                gate_pos: Optional[torch.Tensor] = None, gate_index: int = 0,
                moe_gen: Optional[torch.Generator] = None, capture: bool = False,
                adapter_keep: Optional[torch.Tensor] = None):
        """With MoE experts, returns ``(x, moe_aux)``. The experts route on
        the post-attention residual at ``gate_pos[b]`` (per image) or else
        at ``gate_index``; ``moe_gen`` draws their gate noise and dropout
        (none without it). The adapter reads the raw post-attention residual
        (not ``ln_2(x)``), with ``adapter_keep`` its dropout mask. With
        ``capture`` (no MoE), returns ``(x, (ln_1(x), residual))`` in f32."""
        ln1 = layer_norm(self.ln_1, x, self.dtype)
        x = x + self.attn(ln1, prefix_kv, attn_mask)
        y = self.mlp(layer_norm(self.ln_2, x, self.dtype))
        if self.adaptmlp is not None:
            y = y + self.adaptmlp(x, adapter_keep)
        if capture:
            return x + y, (ln1.float(), x.float())
        if self.moe is None:
            return x + y
        if gate_pos is not None:
            gvec = x[torch.arange(x.shape[0], device=x.device), gate_pos]
        else:
            gvec = x[:, gate_index, :]
        draws = self.moe.draws(x, moe_gen) if moe_gen is not None else (None, None)
        moe_out, aux = self.moe(x, gvec, *draws)
        return x + (y + moe_out), aux


class VisionTransformer(nn.Module):
    """ViT-B/16 by default; ``forward`` takes float NHWC images and returns
    ``{"features", "tokens"}`` in f32, and ``"moe_aux"`` with MoE experts.
    ``ln_pre`` and ``act="quick_gelu"`` make the CLIP visual tower."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        dtype=torch.bfloat16,
        block_ln_eps: float = 1e-6,
        final_ln_eps: float = 1e-6,
        generator: Optional[torch.Generator] = None,
        ln_pre: bool = False,
        act: str = "gelu",
        moe_experts: int = 0,
        moe_top_k: int = 2,
        adapter_dim: int = 0,
        adapter_scale: float = 0.1,
    ):
        super().__init__()
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.adapter_dim, self.adapter_scale = adapter_dim, adapter_scale
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim))
        # OpenAI CLIP normalises the embedded sequence before the blocks
        self.ln_pre = nn.LayerNorm(embed_dim, eps=1e-5) if ln_pre else None
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, dtype, block_ln_eps, act,
                     moe_experts, moe_top_k, adapter_dim, adapter_scale)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=final_ln_eps)
        self.reset_parameters(generator)

    def reset_parameters(self, gen=None) -> None:
        with torch.no_grad():
            lecun_normal_(self.patch_embed.weight, 3 * self.patch_size ** 2, gen)
            self.patch_embed.bias.zero_()
            trunc_normal_02_(self.cls_token, gen)
            trunc_normal_02_(self.pos_embed, gen)
        if self.ln_pre is not None:
            self.ln_pre.reset_parameters()
        for blk in self.blocks:
            blk.reset_parameters(gen)
        self.norm.reset_parameters()

    def forward(
        self,
        x: torch.Tensor,
        prepend_tokens: Optional[torch.Tensor] = None,
        feature_mode: str = "cls",
        prefix_kv: Optional[Dict[int, Prefix]] = None,
        moe_gen: Optional[torch.Generator] = None,
        capture: bool = False,
        capture_point: str = "attn",
        adapter_keep: Optional[List[torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """``prefix_kv[i]``, where present, is block i's prompt (pk, pv);
        ``moe_gen`` draws the MoE experts' training noise and dropout;
        ``adapter_keep[i]`` is block i's adapter dropout mask. With
        ``capture``, ``"attn_inputs"`` holds each block's ``ln_1(x)``
        (``capture_point="attn"``) or its raw post-attention residual, the
        adapter's input (``"mlp"``), in f32."""
        if self.moe_experts > 0 and capture:
            raise NotImplementedError("moe_experts > 0 does not support capture")
        if capture_point not in ("attn", "mlp"):
            raise ValueError(f"unknown capture_point {capture_point!r}")
        dt = self.dtype
        b = x.shape[0]
        pe = self.patch_embed
        x = F.conv2d(
            x.permute(0, 3, 1, 2).to(dt), pe.weight.to(dt), pe.bias.to(dt),
            stride=self.patch_size,
        )
        x = x.flatten(2).transpose(1, 2)  # (B, patches, D), row-major patch order
        cls = self.cls_token.to(dt).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if self.ln_pre is not None:
            x = layer_norm(self.ln_pre, x, dt)
        n_prompt = 0
        if prepend_tokens is not None:
            n_prompt = prepend_tokens.shape[1]
            x = torch.cat([prepend_tokens.to(dt), x], dim=1)
        moe_aux = 0.0
        attn_inputs = []
        for i, blk in enumerate(self.blocks):
            pkv = prefix_kv.get(i) if prefix_kv else None
            keep = adapter_keep[i] if adapter_keep is not None else None
            if self.moe_experts > 0:
                # the CLS token sits after any prepended prompts
                x, aux = blk(x, pkv, gate_index=n_prompt, moe_gen=moe_gen, adapter_keep=keep)
                moe_aux = moe_aux + aux
            elif capture:
                x, (ln1, residual) = blk(x, pkv, capture=True, adapter_keep=keep)
                attn_inputs.append(residual if capture_point == "mlp" else ln1)
            else:
                x = blk(x, pkv, adapter_keep=keep)
        x = layer_norm(self.norm, x, torch.float32)
        if feature_mode == "prompt_mean" and n_prompt > 0:
            feats = x[:, :n_prompt].mean(dim=1)
        else:
            feats = x[:, n_prompt, :]
        out = {"features": feats, "tokens": x}
        if capture:
            out["attn_inputs"] = attn_inputs
        if self.moe_experts > 0:
            out["moe_aux"] = moe_aux
        return out


@BACKBONES.register(
    "ViTZoo",
    aliases=(
        "vit_base_patch16_224",
        "vit-b-16",
        "vit_pt_imnet",
    ),
)
def vitzoo(**kwargs):
    # configs name the torch activation class (``act_layer: QuickGELU``,
    # configs/dmnsp_vit.yaml)
    act = str(kwargs.get("act_layer", kwargs.get("act", "gelu")))
    return VisionTransformer(
        img_size=int(kwargs.get("img_size", 224)),
        adapter_dim=int(kwargs.get("adapter_dim", 0)),
        # MoE-adapter experts (configs spell them ``experts_num``)
        moe_experts=int(kwargs.get("moe_experts", kwargs.get("experts_num", 0)) or 0),
        moe_top_k=int(kwargs.get("moe_top_k", 2)),
        dtype=kwargs.get("dtype", torch.bfloat16),
        act="quick_gelu" if act.lower() in ("quickgelu", "quick_gelu") else "gelu",
        block_ln_eps=float(kwargs.get("block_ln_eps", 1e-6)),
        final_ln_eps=float(kwargs.get("final_ln_eps", 1e-6)),
        generator=kwargs.get("generator"),
    )


@BACKBONES.register("vit_tiny_test")
def vit_tiny_test(**kwargs):
    """Small ViT for unit tests (32x32/patch 8, 4 blocks). Reads the JAX
    factory's kwargs: ``adapter_dim``, ``dtype`` and the LayerNorm eps (and
    no activation: GELU always); SSF (``ssf``) and VPT-deep (``vpt_len``)
    are not in the port yet."""
    for key in ("ssf", "vpt_len"):
        if kwargs.get(key):
            raise NotImplementedError(
                f"{key}: the ViT's SSF and VPT variants are not in the PyTorch port yet "
                "(ROADMAP Queue 1 item 9)")
    return VisionTransformer(
        img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4,
        adapter_dim=int(kwargs.get("adapter_dim", 0)),
        dtype=kwargs.get("dtype", torch.float32),
        block_ln_eps=float(kwargs.get("block_ln_eps", 1e-6)),
        final_ln_eps=float(kwargs.get("final_ln_eps", 1e-6)),
        generator=kwargs.get("generator"),
    )
