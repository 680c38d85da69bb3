#!/usr/bin/env python
"""GPU smoke run of the PyTorch port (``libcontinual_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; it raises without them. Phases, each of
which raises on failure:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: the kernel libraries ``libcontinual_tpu_torch/ops/csrc/attention.cu``
     and ``conv.cu`` (one ``nvcc`` each, started together), with their ptxas
     reports, and the count of HMMA instructions (tensor-core products) in
     the SASS of each bf16 instantiation of the packed forward and of both
     backward kernels, of the generic forward (6 modes x 4 head dims), of
     the conv weight gradient's partial kernel and of the conv forward (both
     block shapes) (none in the f32 ones);
  3. kernel checks, forward and backward, against the plain PyTorch versions:
     the packed-qkv kernels at a small odd shape (f32, bf16) and at the
     slices' shapes (B 16, S 197, 202 and 222, D 768, 12 heads, bf16); the
     prefix-KV kernels at a small odd shape (f32, bf16), at the DualPrompt
     and CODA shapes (B 16, S 197, P 3, 4 and 10, bf16), with a prompt
     broadcast over the batch (batch stride 0) and with one that differs per
     image; the masked kernels at small odd shapes (S 17 and 77, f32 and
     bf16, with the causal mask and with a random finite one) and at the
     CLIP text tower's (B 16, S 77, D 512, 8 heads, bf16, causal); all three
     families also past the first kernels' limits (``LONG``, ``P_LONG``,
     ``M_LONG``: S 300 at hd 128, 257 keys, hd 48 and 20) and at the edges of
     the tensor-core kernels' 16- and 64-row tiles (``EDGE``, ``P_EDGE``,
     ``M_EDGE``: S 16, 64, 65 and 128 at hd 64; P + S 64 and 65); each bf16
     backward twice at its timed shape, and the bf16 conv forward (y, and
     dx on the rotated taps), conv weight gradient and generic forward
     (exact and ``fast``) twice at theirs, whose two results must be equal
     bit for bit; the 3x3
     convolution kernels (y, dx through the forward kernel on the rotated
     taps, and dw) at small odd shapes (f32, bf16, C 3 and 20, a 4 x 4 image)
     and at resnet18's CIFAR stem and four stages at B 128 (bf16);
  4. the slices: the port's ``Trainer`` (the code behind
     ``python -m libcontinual_tpu_torch``) runs L2P, DualPrompt, CODA-Prompt
     and DAP (on a long-tailed ``imb_type: exp`` stream) on a full-width
     ViT-B/16, and MoE-Adapter4CL and RAPF on a full-width CLIP (ViT-B/16
     and the 12-block text tower over the prompts of all 100 classes), from
     random init, each for 2 tasks of 10 synthetic classes stored at 32 px
     and resized to 224 in the step, with the launch counts and the launch
     shapes of each run (every shape must be one that phase 3 checked); then
     one full-width batch goes through the trained L2P, DualPrompt, DAP and
     MoE-Adapter4CL states with the kernels and with the plain attention,
     and the two agree; then iCaRL on a full-width resnet18 (CIFAR stem,
     bf16, batch 128, herding buffer 200), 2 tasks of 10 classes and 2
     epochs, and on its trained network the inputs and output gradients of
     its 14 stride-1 3x3 convolutions on one batch of 128 go through
     ``conv3x3`` (the kernels), which must agree with the modules' own cuDNN
     results (y, dx, dw);
  5. timing: each attention kernel against its plain version and against
     ``scaled_dot_product_attention`` on the flash and cuDNN backends (the
     backward's dq and dk/dv kernels also apart, from ``torch.profiler``), and
     each conv kernel against its plain version and cuDNN (the yardsticks,
     which the port never calls) at the main path's shapes, the forward also
     as dx (on the output gradient and the rotated taps, beside cuDNN's data
     gradient); the L2P, DualPrompt and MoE-Adapter4CL train steps at the
     bench geometry (batch 128, bf16, 32 -> 224) with the kernels and with
     the plain attention, and the iCaRL / resnet18 step
     (batch 128, bf16, 32 px), with a device-time breakdown of the L2P,
     DualPrompt, MoE-Adapter4CL and iCaRL steps from ``torch.profiler``;
     and the whole 10-task iCaRL protocol of ``bench.py``'s end-to-end block
     through the trainer: wall time and final accuracy;
  6. the generic attention op (``fused_attention``) and the Pallas
     variants of the measurement tools, all on the kernel of
     ``generic_attention.cuh``: the kernel and each variant against their
     plain versions at small odd shapes (f32, bf16; Skv above and below Sq,
     300 keys at hd 128) and at the shapes the phases below give them
     (bf16); the path: every attention block's q, k and v and output
     gradient, captured from one batch of 128 through the trained L2P
     state's prompted pass (S 222) and DualPrompt's prefixed pass (Sq 197;
     Skv 200 and 207 where the prompt keys go in front), sent through
     ``fused_attention`` forward and backward against the packed and prefix
     kernels' own results; timing of the kernel beside its plain version,
     SDPA (flash and cuDNN backends) and the bound at the ViT-B/16, CLIP
     text and one long shape, and of each variant at the tool's shape
     (``mmonly`` beside its function as two cuBLAS products); and
     the port's two tools, ``bench_attention`` and ``exp_flash_kernel``, at
     their defaults, whose launches are the variants' counts.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# bf16 kernels: the plain version has the same rounding points, so only a
# sum-order difference that flips one bf16 rounding can show: two bf16 ulps
# at the largest magnitude of the reference. f32: summation order only.
TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
# one full-width batch through 12 bf16 blocks, kernels vs plain attention:
# per-layer one-ulp differences compound through the residual stream
SLICE_TOL = 5e-2
# the same batch with the ViT in f32: summation order only, through 12 blocks
SLICE_TOL_F32 = 1e-4

SMALL = (2, 17, 64, 4)  # (B, S, D, heads)
# the sequence lengths the slices give the packed-qkv kernels: 197 (the query
# pass, and DualPrompt's and CODA's blocks 5-11), 202 (DAP: 5 prompt tokens)
# and 222 (L2P: 5 x 5 prompt tokens); phase_slice fails on any other
MAIN = [(16, s, 768, 12) for s in (197, 202, 222)]
TIMED = (128, 222, 768, 12)
P_SMALL = (2, 17, 3, 64, 4)  # (B, S, P, D, heads)
P_MAIN = [(16, 197, p, 768, 12) for p in (3, 4, 10)]  # DualPrompt g / CODA / DualPrompt e
P_TIMED = (128, 197, 10, 768, 12)
M_SMALL = [(2, 17, 64, 4), (2, 77, 64, 4)]  # (B, S, D, heads)
M_MAIN = [(16, 77, 512, 8)]  # the CLIP text tower: context 77, width 512, 8 heads
M_TIMED = (100, 77, 512, 8)  # MoE-Adapter4CL encodes the prompts of all 100 classes a step
# past the 256 keys and the 16/32/64 head dims of the packed kernels' first
# version (no slice reaches them yet): S 300 at hd 128, S 260 at hd 48, and
# hd 20, whose 40-byte rows the forward stages element by element. Prefix:
# P + S = 257 at hd 128 with a broadcast prompt, P 70 (the second key tile
# straddles P) in f32, hd 48. Every key count is no multiple of 64.
LONG = [((1, 300, 256, 2), torch.float32), ((1, 300, 256, 2), torch.bfloat16),
        ((2, 260, 144, 3), torch.bfloat16), ((2, 33, 60, 3), torch.bfloat16)]
P_LONG = [((2, 250, 7, 256, 2), torch.bfloat16, "broadcast"),
          ((2, 230, 70, 128, 2), torch.float32, "image"),
          ((2, 260, 4, 144, 3), torch.bfloat16, "image")]
M_LONG = [((1, 300, 256, 2), torch.bfloat16, "causal"), ((2, 260, 144, 3), torch.float32, "random"),
          ((2, 33, 60, 3), torch.bfloat16, "causal")]
# the edges of the tensor-core kernels' tiles at hd 64: a warp's 16 rows and
# a block's 64 (S 16, 64, 65, 128); prefix P + S = 64, 65, 128 and 130
EDGE = [((2, s, 128, 2), dtype) for s in (16, 64, 65, 128)
        for dtype in (torch.float32, torch.bfloat16)]
P_EDGE = [((2, s, p, 128, 2), dtype, "image") for s, p in ((16, 48), (64, 1), (65, 63), (128, 2))
          for dtype in (torch.float32, torch.bfloat16)]
M_EDGE = [((2, s, 128, 2), dtype, kind) for s in (16, 64, 65, 128)
          for dtype, kind in ((torch.float32, "random"), (torch.bfloat16, "causal"))]

# the 3x3 convolution (B, H, W, C, O): small odd shapes, and resnet18's CIFAR
# stem and four stages at batch 128 (bf16), the shapes its iCaRL path gives
C_SMALL = [((3, 5, 7, 3, 8), torch.float32), ((3, 5, 7, 3, 8), torch.bfloat16),
           ((2, 9, 6, 20, 24), torch.float32), ((2, 9, 6, 20, 24), torch.bfloat16),
           ((2, 4, 4, 20, 24), torch.bfloat16), ((5, 3, 3, 7, 70), torch.float32)]
C_MAIN = [(128, 32, 32, 3, 64), (128, 32, 32, 64, 64), (128, 16, 16, 128, 128),
          (128, 8, 8, 256, 256), (128, 4, 4, 512, 512)]
C_TIMED = C_MAIN[1]  # the first stage: the conv kernels' numbers in the kernels line
# the trained iCaRL network's captured batch through conv3x3 against the
# modules' own cuDNN results: both bf16 from f32 sums in another order (dw:
# f32 against cuDNN's bf16), relative L2
CONV_PATH_TOL = 1e-2

# the generic attention forward (B, H, Sq, Skv, hd): small odd shapes (Skv
# above and below Sq, 300 keys at hd 128, Sq == Skv for flash), f32 and bf16
G_SMALL = [(2, 3, 9, 13, 8), (1, 2, 17, 5, 16), (2, 1, 33, 300, 128), (2, 3, 17, 17, 16)]
# and at the shapes the path and tool phases launch it at, bf16, at B 16 (a
# check covers any batch): L2P's prompted pass (S 222), DualPrompt's prefixed
# pass (Sq 197; Skv 197, 200, 207), the tools' S 217, 197 and 222; plus the
# long timed shape at B 2
G_MAIN = [(16, 12, 222, 222, 64), (16, 12, 197, 197, 64), (16, 12, 197, 200, 64),
          (16, 12, 197, 207, 64), (16, 12, 217, 217, 64), (2, 12, 1024, 1024, 128)]
# the fast variant on bf16 scores: a sum-order difference that flips the bf16
# rounding of one score moves that key's weight by up to 2^(2^-5) - 1 = 2.2%
# at |s| < 8, in either dtype
BF16SM_TOL = 3e-2
# the generic op (P in f32) against the packed and prefix kernels (P and dS
# rounded to bf16 before their products: a relative 2^-9 on each term) on the
# path's own blocks, output and dq, dk, dv; relative L2
GENERIC_PATH_TOL = 1e-2
# exp_flash_kernel's check: flash (P and the output in bf16) against the f32
# forward; P's rounding moves an output by up to 2^-9 max |v| (1.1e-2 at
# |v| < 5.5, randn at these sizes) and the output's own by half an ulp
# (3.9e-3 below 2)
FLASH_F32_TOL = 2e-2
# timed: (label, B, H, Sq, Skv, hd), bf16; the first is the kernels line's
G_TIMED = [("ViT-B/16", 128, 12, 197, 197, 64), ("DualPrompt e-prefix", 128, 12, 197, 207, 64),
           ("L2P prompted", 128, 12, 222, 222, 64), ("CLIP text, unmasked", 100, 8, 77, 77, 64),
           ("long", 8, 12, 1024, 1024, 128)]
G_TOOL = (128, 12, 217, 217, 64)  # tools/bench_attention.py's default
G_FLASH = (128, 12, 197, 197, 64)  # tools/exp_flash_kernel.py's first length

# the main paths of the generic kernel and of its variants in the kernels line
GENERIC_PATH = "generic attention: L2P and DualPrompt blocks through fused_attention"
TOOLS_PATH = "tools: bench_attention and exp_flash_kernel"

# the TPU kernel each CUDA kernel replaces (its body's line) and the source
# of the CUDA kernel
_ATTN_CU = "libcontinual_tpu_torch/ops/csrc/attention.cu"
_CONV_CU = "libcontinual_tpu_torch/ops/csrc/conv.cu"
_GEN_CUH = "libcontinual_tpu_torch/ops/csrc/generic_attention.cuh"
SOURCE_LINES = {"qkv_fwd": "libcontinual_tpu/ops/attention.py:140",
                "qkv_bwd": "libcontinual_tpu/ops/attention.py:222",
                "pqkv_fwd": "libcontinual_tpu/ops/attention.py:348",
                "pqkv_bwd": "libcontinual_tpu/ops/attention.py:394",
                "mqkv_fwd": "libcontinual_tpu/ops/attention.py:626",
                "mqkv_bwd": "libcontinual_tpu/ops/attention.py:653",
                "conv3x3_fwd": "libcontinual_tpu/ops/conv.py:105",
                "conv3x3_dw": "libcontinual_tpu/ops/conv.py:153",
                "attn_fwd": "libcontinual_tpu/ops/attention.py:841",
                "attn_fwd_v2": "tools/bench_attention.py:38",
                "attn_fwd_fast": "tools/bench_attention.py:55",
                "attn_fwd_mmonly": "tools/bench_attention.py:111",
                "attn_fwd_qblock": "tools/bench_attention.py:150",
                "attn_fwd_flash": "tools/exp_flash_kernel.py:37"}
SOURCES = {k: _CONV_CU if k.startswith("conv") else _ATTN_CU for k in SOURCE_LINES}
# the generic kernels: one template, gattn_kernel, in the mode of each body;
# entries whose bodies compute one function share an instantiation
SOURCES.update({
    "attn_fwd": f"{_GEN_CUH} (gattn_kernel, mode kExact; exported by attention.cu)",
    "attn_fwd_v2": f"{_GEN_CUH} (gattn_kernel, modes kV2 and kV2NoMax)",
    "attn_fwd_fast": f"{_GEN_CUH} (gattn_kernel, modes kFast and kFastBf16)",
    "attn_fwd_mmonly": f"{_GEN_CUH} (gattn_kernel, mode kMMOnly)",
    "attn_fwd_qblock": f"{_GEN_CUH} (gattn_kernel, mode kFast: the instantiation of "
                       "attn_fwd_fast, the same function)",
    "attn_fwd_flash": f"{_GEN_CUH} (gattn_kernel, mode kV2: the instantiation of "
                      "attn_fwd_v2 with the max, the same function on Sq == Skv)",
})
# the variant timed for each variant entry of the kernels line
G_VARIANT_OF = {"attn_fwd_v2": "v2", "attn_fwd_fast": "fast", "attn_fwd_mmonly": "mmonly",
                "attn_fwd_qblock": "qblock", "attn_fwd_flash": "flash"}

# H100 SXM: HBM bandwidth and dense bf16 tensor-core peak (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

BENCH_CONFIG = {
    "dataset": "synthetic", "data_root": "", "image_size": 32,
    "task_num": 10, "init_cls_num": 10, "inc_cls_num": 10,
    "epoch": 1, "batch_size": 128, "seed": 1993, "dtype": "bfloat16",
    "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "ViTZoo", "kwargs": {}},
    "classifier": {"name": "L2P", "kwargs": {
        "num_class": 100, "feat_dim": 768, "init_cls_num": 10, "inc_cls_num": 10,
        "task_num": 10, "prompt_length": 5, "pool_size": 10, "top_k": 5,
        "pull_constraint_coeff": 0.1}},
    "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001875}},
    "lr_scheduler": {"name": "Constant"},
}
# the shipped configs' method settings (configs/dualprompt.yaml,
# configs/codaprompt.yaml, configs/dap.yaml)
METHOD_KWARGS = {
    "L2P": BENCH_CONFIG["classifier"]["kwargs"],
    "DualPrompt": {"e_prompt_length": 20, "g_prompt_length": 6, "pool_size": 10},
    "CodaPrompt": {"prompt_length": 8, "pool_size": 100, "mu": 0.0},
    "DAP": {"length": 5, "top_k": 1},
}
_CLIP_COMMON = {
    "dataset": "synthetic", "data_root": "", "image_size": 224,
    "task_num": 10, "init_cls_num": 10, "inc_cls_num": 10, "batch_size": 128,
    "seed": 1993, "dtype": "bfloat16", "mesh": {"data": 1, "model": 1},
}
# configs/moe_adapter4cl.yaml and configs/rapf10-10.yaml as dicts (the card's
# machine need not have PyYAML)
CLIP_CONFIGS = {
    "MoE_Adapter4CL": {
        **_CLIP_COMMON, "epoch": 5,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001, "betas": [0.9, 0.999]}},
        "lr_scheduler": {"name": "CosineSchedule", "kwargs": {"K": 5}},
        "backbone": {"name": "clip", "kwargs": {
            "moe_text_gate": "eot", "moe_experts": 4, "moe_top_k": 2}},
        "classifier": {"name": "MOE_ADAPTER4CL", "kwargs": {
            "num_class": 100, "feat_dim": 512, "init_cls_num": 10, "inc_cls_num": 10,
            "task_num": 10, "prompt_template": "a photo of a {}."}},
    },
    "RAPF": {
        **_CLIP_COMMON, "epoch": 15, "is_rapf": True,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001, "betas": [0.9, 0.999]}},
        "lr_scheduler": {"name": "MultiStepLR", "kwargs": {"gamma": 0.1, "milestones": [4, 10]}},
        "backbone": {"name": "clip", "kwargs": {}},
        "classifier": {"name": "RAPF", "kwargs": {
            "num_class": 100, "feat_dim": 512, "init_cls_num": 10, "inc_cls_num": 10,
            "task_num": 10, "prompt_template": "a good photo of a {}", "beta": 2,
            "shrinkage": False, "threshold": 0.55, "mix_bias": 0.6}},
    },
}
# parameters that must move in a slice's run
_MOE = "clip.{}.blocks.{}.moe.{}"
TRAINED = {
    "L2P": ("head.dense.weight", "prompt.prompt", "prompt.key"),
    "DualPrompt": ("head.dense.weight", "prompt.g_p_0", "prompt.e_p_2", "prompt.e_k_2"),
    "CodaPrompt": ("head.dense.weight", "prompt.e_p_0", "prompt.e_k_0", "prompt.e_a_0"),
    "DAP": ("head.dense.weight", "prompt.taskprompt", "prompt.generalprompt"),
    "MoE_Adapter4CL": ("clip.logit_scale",) + tuple(
        _MOE.format(tower, block, leaf) for tower in ("visual", "text") for block in (0, 11)
        for leaf in ("w_gate", "down", "up")),
    "RAPF": ("adapter.kernel",),
}
PREFIX_BLOCKS = 5  # DualPrompt and CODA-Prompt put prefixes on blocks 0-4

_NORM = {"mean": [0.5071, 0.4865, 0.4409], "std": [0.2673, 0.2564, 0.2762]}
# bench.py's end-to-end block (bench.py:207-235): 10-task iCaRL on resnet18,
# synthetic CIFAR-100 geometry, 60 images a class, the cifar transform stack.
# The synthetic source does not trigger the CIFAR stem (nor the cifar
# transform preset), so the backbone is told its dataset, as a CIFAR-100 run
# gets it from the config: the 3x3 stride-1 stem, stages at 32, 16, 8 and 4 px
ICARL_CONFIG = {
    "dataset": "synthetic", "data_root": "", "image_size": 32,
    "task_num": 10, "init_cls_num": 10, "inc_cls_num": 10,
    "epoch": 2, "batch_size": 128, "per_class": 60, "seed": 1993,
    "val_per_epoch": 0, "testing_times": 1, "dtype": "bfloat16",
    "mesh": {"data": 1, "model": 1},
    "train_trfms": [{"RandomCrop": {"size": 32, "padding": 4}}, {"RandomHorizontalFlip": {}},
                    {"ColorJitter": {"brightness": 63 / 255}}, {"Normalize": _NORM}],
    "test_trfms": [{"Normalize": _NORM}],
    "backbone": {"name": "resnet18", "kwargs": {"dataset": "cifar100"}},
    "classifier": {"name": "ICarl", "kwargs": {
        "num_class": 100, "feat_dim": 512, "init_cls_num": 10, "inc_cls_num": 10,
        "task_num": 10}},
    "buffer": {"name": "LinearHerdingBuffer", "kwargs": {"buffer_size": 200, "batch_size": 128}},
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9}},
    "lr_scheduler": {"name": "Constant"}, "warmup": 0,
}
RESNET18_CIFAR_PARAMS = 11_168_832  # backbone parameters at 64-512 channels


def _err(out: torch.Tensor, ref: torch.Tensor):
    """(max abs error, the same over max(1, max |ref|))."""
    abs_err = float((out.float() - ref.float()).abs().max())
    return abs_err, abs_err / max(1.0, float(ref.float().abs().max()))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _attention_modules():
    from libcontinual_tpu_torch.ops import attention as A
    from libcontinual_tpu_torch.ops import masked_attention as MA
    from libcontinual_tpu_torch.ops import prefix_attention as PA

    return A, PA, MA


def _conv_module():
    from libcontinual_tpu_torch.ops import conv

    return conv


def _reset_launches() -> None:
    for mod in (*_attention_modules(), _conv_module()):
        mod.reset_launches()


def _launches() -> dict:
    A, PA, MA = _attention_modules()
    return {**A.LAUNCHES, **PA.LAUNCHES, **MA.LAUNCHES, **_conv_module().LAUNCHES}


def _shape_key(kname, qkv, *rest):
    """(kernel, S, [P,] D, heads, dtype) of one attention launch, or (kernel,
    H, W, C, O, dtype) of one conv launch (x and the taps or the output
    gradient), or (kernel or variant, H, Sq, Skv, hd, dtype) of one generic
    launch (q, k, ...): what a check at that shape covers, whatever the
    batch."""
    if kname.startswith(("attn", "variant")):
        return (kname, *qkv.shape[1:3], rest[0].shape[2], qkv.shape[3], qkv.dtype)
    if kname.startswith("conv"):
        return (kname, *qkv.shape[1:], rest[0].shape[-1], qkv.dtype)
    s, d, heads = qkv.shape[1], qkv.shape[2] // 3, rest[-1]
    p = (rest[0].shape[1],) if kname.startswith("pqkv") else ()
    return (kname, s, *p, d, heads, qkv.dtype)


@contextlib.contextmanager
def _recorded_shapes(seen: set):
    """Within it, every launch of a kernel wrapper adds its ``_shape_key`` to
    ``seen``; the wrappers themselves run (and count) as before."""
    A, PA, MA = _attention_modules()
    C = _conv_module()
    wrapped = [(A, "qkv_attention_cuda", "qkv_fwd"), (A, "qkv_attention_bwd_cuda", "qkv_bwd"),
               (PA, "prefix_attention_cuda", "pqkv_fwd"),
               (PA, "prefix_attention_bwd_cuda", "pqkv_bwd"),
               (MA, "masked_attention_cuda", "mqkv_fwd"),
               (MA, "masked_attention_bwd_cuda", "mqkv_bwd"),
               (C, "conv3x3_cuda", "conv3x3_fwd"), (C, "conv3x3_dw_cuda", "conv3x3_dw"),
               (A, "attention_cuda", "attn_fwd"), (A, "attention_variant_cuda", None)]
    saved = [getattr(mod, attr) for mod, attr, _ in wrapped]

    def recording(fn, kname):
        def call(*args):
            # a variant launch is keyed by its variant (its last argument)
            seen.add(_shape_key(kname or f"variant {args[-1]}", *args))
            return fn(*args)
        return call

    for (mod, attr, kname), fn in zip(wrapped, saved):
        setattr(mod, attr, recording(fn, kname))
    try:
        yield
    finally:
        for (mod, attr, _), fn in zip(wrapped, saved):
            setattr(mod, attr, fn)


# ------------------------------------------------------------------ phases


_MODES = {"0": "qkv", "1": "pqkv", "2": "mqkv"}
_GEN_MODES = ("kExact", "kV2", "kV2NoMax", "kFast", "kFastBf16", "kMMOnly")


def phase_build():
    from libcontinual_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()  # every library: one nvcc each, all started together
    print(f"[build] {', '.join(n + '.cu' for n in _build.LIBRARIES)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib_name in _build.LIBRARIES:
        log_path = _build.library_path(lib_name) + ".ptxas.txt"
        with open(log_path) as f:
            log = f.read()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] ptxas {lib_name}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, at most {max(spills, default=0)} bytes of spill stores "
              f"({log_path})")
        # one line per kernel (family, kernel, type, head dim): registers, spills
        for chunk in log.split("Compiling entry function")[1:]:
            nreg = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            attn = re.search(r"(attn_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)ELi(\d)E", chunk)
            conv = re.search(r"(conv3x3_\w+?_kernel)(?:I(f|13__nv_bfloat16)(?:Li(\d)E)?E)?", chunk)
            gen = re.search(r"gattn_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E", chunk)
            if not (nreg and spill):
                continue
            if gen:
                typ, hd, mode = gen.groups()
                label = (f"gen   gattn_kernel {_GEN_MODES[int(mode)]:9s} "
                         f"{'f32' if typ == 'f' else 'bf16':4s} hd {hd:3s}")
            elif attn:
                kind, typ, hd, mode = attn.groups()
                label = f"{_MODES[mode]:5s} {kind:20s} {'f32' if typ == 'f' else 'bf16':4s} hd {hd:2s}"
            elif conv:
                kind, typ, mt = conv.groups()
                dtype = "" if typ is None else "f32" if typ == "f" else "bf16"
                label = f"conv  {kind:25s} {dtype}{'' if mt in (None, '0') else f' MT {mt}'}"
            else:
                continue
            print(f"[build]   {label}: {nreg.group(1)} registers, {spill.group(1)} bytes spill stores")
    _check_tensor_cores(_build)


#: the packed, prefix and masked kernels, each instantiated for 3 modes x 4
#: head dims x {f32, bf16}
TENSOR_CORE_KERNELS = ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")


def _hmma_counts(cuobjdump, library, pattern):
    """{the groups of ``pattern`` matched on a kernel's mangled name: the
    HMMA instructions in its SASS} for every kernel of ``library``."""
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    hmma = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.search(pattern, fn.split()[0])
        if m:
            hmma[m.groups()] = len(re.findall(r"\bHMMA\.", fn))
    return hmma


def _check_tensor_cores(_build):
    """The bf16 instantiations of the packed forward and of both backward
    kernels, of the generic forward ``gattn_kernel`` (6 modes x 4 head dims),
    of ``conv3x3_dw_partial_kernel`` and of ``conv3x3_fwd_kernel`` (both of
    its block shapes) run HMMA (the tensor cores' mma.sync) in the built
    libraries' SASS, and the f32 ones none (CUDA-core FMA: no TF32), as
    ``cuobjdump -sass`` shows."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    attn_lib = _build.library_path("attention")
    hmma = _hmma_counts(cuobjdump, attn_lib,
                        r"lct\d+(attn_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)ELi(\d)E")
    for kernel in TENSOR_CORE_KERNELS:
        bf16 = {(int(mode), int(hd)): n for (k, typ, hd, mode), n in sorted(hmma.items())
                if k == kernel and typ != "f"}
        f32 = [n for (k, typ, _, _), n in hmma.items() if k == kernel and typ == "f"]
        print(f"[build] SASS: HMMA instructions in each bf16 {kernel} (mode, hd): {bf16}; "
              f"in the f32 ones: {sorted(set(f32))}")
        _require(len(bf16) == len(f32) == 12 and all(bf16.values()) and not any(f32),
                 f"the bf16 {kernel} does not run on the tensor cores, or an f32 one does")
    gen = _hmma_counts(cuobjdump, attn_lib, r"gattn_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E")
    bf16 = {(_GEN_MODES[int(mode)], int(hd)): n for (typ, hd, mode), n in sorted(gen.items())
            if typ != "f"}
    f32 = [n for (typ, _, _), n in gen.items() if typ == "f"]
    print(f"[build] SASS: HMMA instructions in each bf16 gattn_kernel (mode, hd): {bf16}; "
          f"in the f32 ones: {sorted(set(f32))}")
    _require(len(bf16) == len(f32) == 24 and all(bf16.values()) and not any(f32),
             "the bf16 gattn_kernel does not run on the tensor cores, or an f32 one does")
    conv_lib = _build.library_path("conv")
    conv = _hmma_counts(cuobjdump, conv_lib, r"(conv3x3_dw_partial_kernel)I(f|13__nv_bfloat16)E")
    bf16 = [n for (_, typ), n in conv.items() if typ != "f"]
    f32 = [n for (_, typ), n in conv.items() if typ == "f"]
    print(f"[build] SASS: HMMA instructions in the bf16 conv3x3_dw_partial_kernel: {bf16}; "
          f"in the f32 one: {f32}")
    _require(len(bf16) == len(f32) == 1 and all(bf16) and not any(f32),
             "the bf16 conv3x3_dw_partial_kernel does not run on the tensor cores, or the f32 "
             "one does")
    # the forward: one bf16 instantiation for each block shape (MT 2 and 4:
    # 128 and 256 pixels), one f32
    fwd = _hmma_counts(cuobjdump, conv_lib, r"conv3x3_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E")
    bf16 = {int(mt): n for (typ, mt), n in sorted(fwd.items()) if typ != "f"}
    f32 = [n for (typ, _), n in fwd.items() if typ == "f"]
    print(f"[build] SASS: HMMA instructions in each bf16 conv3x3_fwd_kernel (MT): {bf16}; "
          f"in the f32 one: {f32}")
    _require(len(bf16) == 2 and len(f32) == 1 and all(bf16.values()) and not any(f32),
             "the bf16 conv3x3_fwd_kernel does not run on the tensor cores, or the f32 one does")


def _inputs(shape, dtype, dev, seed):
    b, s, d, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * d, device=dev, generator=g).to(dtype)
    go = torch.randn(b, s, d, device=dev, generator=g).to(dtype)
    return qkv, go


def phase_checks(dev, errs, checked):
    """The packed-qkv kernels against their plain versions; adds the
    ``_shape_key`` of each checked shape to ``checked``."""
    A, _, _ = _attention_modules()
    cases = [(SMALL, torch.float32), (SMALL, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in MAIN] + LONG + EDGE
    for i, (shape, dtype) in enumerate(cases):
        b, s, d, h = shape
        scale = (d // h) ** -0.5
        qkv, go = _inputs(shape, dtype, dev, seed=i)
        checked.update(_shape_key(k, qkv, h) for k in ("qkv_fwd", "qkv_bwd"))
        out = A.qkv_attention_cuda(qkv, scale, h)
        torch.cuda.synchronize()
        abs_f, rel_f = _err(out, A.qkv_attention_plain(qkv, scale, h))
        x = qkv.clone().requires_grad_()
        A.fused_qkv_attention(x, scale, h).backward(go)
        torch.cuda.synchronize()
        abs_b, rel_b = _err(x.grad, A.qkv_attention_bwd_plain(qkv, go, scale, h))
        tag = f"B {b} S {s} D {d} H {h} {str(dtype).split('.')[-1]}"
        print(f"[fwd check] qkv {tag}: max abs err {abs_f:.3e}, scaled {rel_f:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        print(f"[bwd check] qkv {tag}: max abs err {abs_b:.3e}, scaled {rel_b:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        _require(rel_f <= TOL[dtype], f"forward kernel disagrees at {tag}")
        _require(rel_b <= TOL[dtype], f"backward kernel disagrees at {tag}")
        if shape in MAIN:
            errs["qkv_fwd"] = max(errs["qkv_fwd"], abs_f)
            errs["qkv_bwd"] = max(errs["qkv_bwd"], abs_b)


def _prefix_inputs(shape, dtype, dev, seed, layout):
    """qkv, pk, pv, g; ``layout`` "image" gives each image its own prompt
    rows, "broadcast" one prompt expanded over the batch (batch stride 0)."""
    b, s, p, d, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * d, device=dev, generator=gen).to(dtype)
    go = torch.randn(b, s, d, device=dev, generator=gen).to(dtype)
    rows = b if layout == "image" else 1
    pk, pv = (torch.randn(rows, p, d, device=dev, generator=gen).to(dtype).expand(b, -1, -1)
              for _ in range(2))
    return qkv, pk, pv, go


def phase_prefix_checks(dev, errs, checked):
    """The prefix-KV kernels against their plain versions; adds the
    ``_shape_key`` of each checked shape to ``checked``."""
    _, PA, _ = _attention_modules()
    cases = [(P_SMALL, torch.float32, "image"), (P_SMALL, torch.bfloat16, "image"),
             (P_SMALL, torch.float32, "broadcast")]
    cases += [(shape, torch.bfloat16, "image") for shape in P_MAIN]
    cases += [(P_MAIN[0], torch.bfloat16, "broadcast")] + P_LONG + P_EDGE
    for i, (shape, dtype, layout) in enumerate(cases):
        b, s, p, d, h = shape
        scale = (d // h) ** -0.5
        qkv, pk, pv, go = _prefix_inputs(shape, dtype, dev, seed=100 + i, layout=layout)
        checked.update(_shape_key(k, qkv, pk, h) for k in ("pqkv_fwd", "pqkv_bwd"))
        if layout == "image":
            _require(not torch.equal(pk[0], pk[1]), "per-image prompt rows are equal")
        else:
            _require(pk.stride(0) == 0, "broadcast prompt is not stride 0")
        out = PA.prefix_attention_cuda(qkv, pk, pv, scale, h)
        torch.cuda.synchronize()
        abs_f, rel_f = _err(out, PA.prefix_attention_plain(qkv, pk, pv, scale, h))
        got = PA.prefix_attention_bwd_cuda(qkv, pk, pv, go, scale, h)
        torch.cuda.synchronize()
        ref = PA.prefix_attention_bwd_plain(qkv, pk, pv, go, scale, h)
        errs_b = [_err(a, r) for a, r in zip(got, ref)]
        abs_b, rel_b = max(e[0] for e in errs_b), max(e[1] for e in errs_b)
        tag = f"B {b} S {s} P {p} D {d} H {h} {str(dtype).split('.')[-1]} {layout} prompt"
        print(f"[fwd check] pqkv {tag}: max abs err {abs_f:.3e}, scaled {rel_f:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        print(f"[bwd check] pqkv {tag}: max abs err (dqkv, dpk, dpv) "
              f"{', '.join(f'{e[0]:.3e}' for e in errs_b)}, scaled {rel_b:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        _require(rel_f <= TOL[dtype], f"prefix forward kernel disagrees at {tag}")
        _require(rel_b <= TOL[dtype], f"prefix backward kernel disagrees at {tag}")
        if shape in P_MAIN:
            errs["pqkv_fwd"] = max(errs["pqkv_fwd"], abs_f)
            errs["pqkv_bwd"] = max(errs["pqkv_bwd"], abs_b)
    # the autograd function sums a broadcast prompt's per-image gradients
    qkv, pk, pv, go = _prefix_inputs(P_SMALL, torch.float32, dev, seed=7, layout="broadcast")
    leaf = pk[:1].clone().requires_grad_()
    PA.fused_prefix_attention(qkv, leaf.expand_as(pk), pv, 0.125, P_SMALL[-1]).backward(go)
    ref = PA.prefix_attention_bwd_plain(qkv, pk, pv, go, 0.125, P_SMALL[-1])[1].sum(0)
    abs_s, _ = _err(leaf.grad[0], ref)
    print(f"[bwd check] pqkv broadcast prompt through autograd: dpk summed over the batch, "
          f"max abs err {abs_s:.3e} (tolerance {TOL[torch.float32]:.1e})")
    _require(abs_s <= TOL[torch.float32] * max(1.0, float(ref.abs().max())),
             "broadcast prompt gradient disagrees")


def _masked_inputs(shape, dtype, dev, seed, kind):
    """qkv, mask, g; ``kind`` "causal" is the text tower's -1e30 mask, "random"
    a general finite additive mask."""
    b, s, d, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * d, device=dev, generator=gen).to(dtype)
    go = torch.randn(b, s, d, device=dev, generator=gen).to(dtype)
    if kind == "causal":
        mask = torch.triu(torch.full((s, s), -1e30, device=dev), diagonal=1)
    else:
        mask = 3.0 * torch.randn(s, s, device=dev, generator=gen)
    return qkv, mask, go


def phase_masked_checks(dev, errs, checked):
    """The masked kernels against their plain versions; adds the
    ``_shape_key`` of each checked shape to ``checked``."""
    _, _, MA = _attention_modules()
    cases = [(shape, dtype, kind) for shape in M_SMALL for dtype in (torch.float32, torch.bfloat16)
             for kind in ("causal", "random")]
    cases += [(shape, torch.bfloat16, "causal") for shape in M_MAIN] + M_LONG + M_EDGE
    for i, (shape, dtype, kind) in enumerate(cases):
        b, s, d, h = shape
        scale = (d // h) ** -0.5
        qkv, mask, go = _masked_inputs(shape, dtype, dev, seed=200 + i, kind=kind)
        checked.update(_shape_key(k, qkv, mask, h) for k in ("mqkv_fwd", "mqkv_bwd"))
        out = MA.masked_attention_cuda(qkv, mask, scale, h)
        torch.cuda.synchronize()
        abs_f, rel_f = _err(out, MA.masked_attention_plain(qkv, mask, scale, h))
        x = qkv.clone().requires_grad_()
        MA.fused_masked_qkv_attention(x, mask, scale, h).backward(go)
        torch.cuda.synchronize()
        abs_b, rel_b = _err(x.grad, MA.masked_attention_bwd_plain(qkv, mask, go, scale, h))
        tag = f"B {b} S {s} D {d} H {h} {str(dtype).split('.')[-1]} {kind} mask"
        print(f"[fwd check] mqkv {tag}: max abs err {abs_f:.3e}, scaled {rel_f:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        print(f"[bwd check] mqkv {tag}: max abs err {abs_b:.3e}, scaled {rel_b:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        _require(rel_f <= TOL[dtype], f"masked forward kernel disagrees at {tag}")
        _require(rel_b <= TOL[dtype], f"masked backward kernel disagrees at {tag}")
        if shape in M_MAIN:
            errs["mqkv_fwd"] = max(errs["mqkv_fwd"], abs_f)
            errs["mqkv_bwd"] = max(errs["mqkv_bwd"], abs_b)


def phase_bwd_determinism(dev):
    """Each bf16 backward twice at its timed shape: the gradients agree bit
    for bit (no atomics; every sum runs in a fixed order)."""
    A, PA, MA = _attention_modules()
    h, ph, mh = TIMED[3], P_TIMED[4], M_TIMED[3]
    qkv, go = _inputs(TIMED, torch.bfloat16, dev, seed=11)
    pqkv, pk, pv, pgo = _prefix_inputs(P_TIMED, torch.bfloat16, dev, seed=12, layout="image")
    mqkv, mask, mgo = _masked_inputs(M_TIMED, torch.bfloat16, dev, seed=13, kind="causal")
    calls = {
        ("qkv_bwd", TIMED): lambda: [A.qkv_attention_bwd_cuda(qkv, go, (TIMED[2] // h) ** -0.5, h)],
        ("pqkv_bwd", P_TIMED): lambda: list(PA.prefix_attention_bwd_cuda(
            pqkv, pk, pv, pgo, (P_TIMED[3] // ph) ** -0.5, ph)),
        ("mqkv_bwd", M_TIMED): lambda: [MA.masked_attention_bwd_cuda(
            mqkv, mask, mgo, (M_TIMED[2] // mh) ** -0.5, mh)],
    }
    for (name, shape), call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(first, second)]
        print(f"[determinism] {name} twice at {shape} bf16: outputs bitwise equal {same}")
        _require(all(same), f"{name}: two calls on the same inputs differ")


def phase_fwd_determinism(dev):
    """The redesigned bf16 kernels twice on the same inputs: the conv
    forward (y, and dx on the rotated taps) and weight gradient at
    ``C_TIMED`` and the generic forward (``attention_cuda``, the variant
    ``fast``) at ``G_TIMED[0]``; the results agree bit for bit (no atomics;
    every sum runs in a fixed order)."""
    A, C = _attention_modules()[0], _conv_module()
    x, taps, go = _conv_inputs(C_TIMED, torch.bfloat16, dev, seed=14)
    rotated = C.rotate_taps(taps).contiguous()
    shape = tuple(G_TIMED[0][1:])
    q, k, v = _generic_inputs(shape, torch.bfloat16, dev, seed=15, strided=False)
    scale = shape[-1] ** -0.5
    calls = {
        ("conv3x3_fwd y", C_TIMED): lambda: C.conv3x3_cuda(x, taps),
        ("conv3x3_fwd dx", C_TIMED): lambda: C.conv3x3_cuda(go, rotated),
        ("conv3x3_dw", C_TIMED): lambda: C.conv3x3_dw_cuda(x, go),
        ("attn_fwd", shape): lambda: A.attention_cuda(q, k, v, scale),
        ("attn_fwd_fast", shape): lambda: A.attention_variant_cuda(q, k, v, scale, "fast"),
    }
    for (name, shp), call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        print(f"[determinism] {name} twice at {shp} bf16: outputs bitwise equal {same}")
        _require(same, f"{name}: two calls on the same inputs differ")


def _conv_inputs(shape, dtype, dev, seed):
    """x (B, H, W, C), kaiming-scaled HWIO taps (3, 3, C, O) and an output
    gradient (B, H, W, O)."""
    b, h, w, c, o = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    k = (torch.randn(3, 3, c, o, device=dev, generator=gen) * (2.0 / (9 * c)) ** 0.5).to(dtype)
    go = torch.randn(b, h, w, o, device=dev, generator=gen).to(dtype)
    return x, k, go


def phase_conv_checks(dev, errs, checked):
    """The conv kernels against their plain versions: y, dx (the forward
    kernel on the output gradient and the rotated, C<->O-swapped taps, as
    the backward computes it) and dw (f32); adds the ``_shape_key`` of each
    checked launch to ``checked``."""
    C = _conv_module()
    cases = C_SMALL + [(shape, torch.bfloat16) for shape in C_MAIN]
    for i, (shape, dtype) in enumerate(cases):
        x, k, go = _conv_inputs(shape, dtype, dev, seed=300 + i)
        kr = C.rotate_taps(k).contiguous()
        checked.update({_shape_key("conv3x3_fwd", x, k), _shape_key("conv3x3_fwd", go, kr),
                        _shape_key("conv3x3_dw", x, go)})
        y, dx, dw = C.conv3x3_cuda(x, k), C.conv3x3_cuda(go, kr), C.conv3x3_dw_cuda(x, go)
        torch.cuda.synchronize()
        got = {"y": _err(y, C.conv3x3_plain(x, k)), "dx": _err(dx, C.conv3x3_plain(go, kr)),
               "dw": _err(dw, C.conv3x3_dw_plain(x, go))}
        tol = {"y": TOL[dtype], "dx": TOL[dtype], "dw": TOL[torch.float32]}  # dw is f32
        b, h, w, c, o = shape
        tag = f"B {b} {h}x{w} C {c} -> O {o} {str(dtype).split('.')[-1]}"
        print(f"[conv check] {tag}: max abs err (scaled) " + ", ".join(
            f"{n} {a:.3e} ({r:.3e}, tolerance {tol[n]:.1e})" for n, (a, r) in got.items()))
        for n, (_, r) in got.items():
            _require(dw.dtype == torch.float32 and r <= tol[n], f"conv kernel {n} disagrees at {tag}")
        if shape in C_MAIN:
            errs["conv3x3_fwd"] = max(errs["conv3x3_fwd"], got["y"][0], got["dx"][0])
            errs["conv3x3_dw"] = max(errs["conv3x3_dw"], got["dw"][0])


def _generic_inputs(shape, dtype, dev, seed, strided):
    """q, k, v (B, H, S, hd); ``strided``: views of (B, S, H, hd) tensors, as
    a caller's .transpose(1, 2) gives them."""
    b, h, sq, skv, hd = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        return tuple(torch.randn(b, s, h, hd, device=dev, generator=gen).to(dtype).transpose(1, 2)
                     for s in (sq, skv, skv))
    return tuple(torch.randn(b, h, s, hd, device=dev, generator=gen).to(dtype)
                 for s in (sq, skv, skv))


def _generic_tol(fn, dtype):
    return BF16SM_TOL if fn == "fast_bf16sm" else TOL[dtype]


def phase_generic_checks(dev, errs, checked):
    """The generic kernel (``attention_cuda``) and each variant against their
    plain versions (flash only on Sq == Skv); adds the ``_shape_key`` of each
    checked launch to ``checked``, and keeps the largest error at G_MAIN's
    shapes for the kernels line (a variant's under the entry it counts in)."""
    A = _attention_modules()[0]
    cases = [(shape, dtype) for shape in G_SMALL for dtype in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in G_MAIN]
    for i, (shape, dtype) in enumerate(cases):
        b, h, sq, skv, hd = shape
        scale = hd ** -0.5
        q, k, v = _generic_inputs(shape, dtype, dev, seed=400 + i, strided=i % 2 == 1)
        got = {}
        for fn in ["attention", *A.VARIANTS]:
            if fn == "flash" and sq != skv:
                continue
            if fn == "attention":
                checked.add(_shape_key("attn_fwd", q, k))
                out, ref = A.attention_cuda(q, k, v, scale), A.attention_plain(q, k, v, scale)
            else:
                checked.add(_shape_key(f"variant {fn}", q, k))
                out = A.attention_variant_cuda(q, k, v, scale, fn)
                ref = A.attention_variant_plain(q, k, v, scale, fn)
            torch.cuda.synchronize()
            _require(out.shape == ref.shape and out.dtype == dtype,
                     f"generic {fn}: output {tuple(out.shape)} {out.dtype}")
            got[fn] = _err(out, ref)
        tag = (f"B {b} H {h} Sq {sq} Skv {skv} hd {hd} {str(dtype).split('.')[-1]} "
               f"{'(B, S, H, hd) views' if i % 2 else 'contiguous'}")
        print(f"[generic check] {tag}: max abs err (scaled) " + ", ".join(
            f"{fn} {a:.3e} ({r:.3e}, tolerance {_generic_tol(fn, dtype):.1e})"
            for fn, (a, r) in got.items()))
        for fn, (a, r) in got.items():
            _require(r <= _generic_tol(fn, dtype), f"generic kernel {fn} disagrees at {tag}")
            if shape in G_MAIN:
                key = "attn_fwd" if fn == "attention" else A.VARIANTS[fn][1]
                errs[key] = max(errs[key], a)


def _slice_config(name):
    if name in CLIP_CONFIGS:  # num_class and image_size stay: 100 prompts, 224 px
        cfg = copy.deepcopy(CLIP_CONFIGS[name])
        cfg.update(task_num=2, batch_size=32, per_class=8, epoch=1, val_per_epoch=0)
        cfg["classifier"]["kwargs"]["task_num"] = 2
        return cfg
    cfg = copy.deepcopy(BENCH_CONFIG)
    cfg.update(task_num=2, batch_size=32, per_class=8, val_per_epoch=0)
    cfg["classifier"] = {"name": name, "kwargs": {
        **METHOD_KWARGS[name], "num_class": 20, "feat_dim": 768,
        "init_cls_num": 10, "inc_cls_num": 10, "task_num": 2}}
    if name == "DAP":  # configs/dap.yaml's long-tailed stream
        cfg.update(imb_type="exp", imb_factor=0.01, shuffle=False)
    return cfg


def phase_slice(dev, name, seen):
    """``name`` through the trainer at full ViT-B/16 width; adds the shape
    of each kernel launch to ``seen``, and returns the trainer, this run's
    launch counts and its number of train steps."""
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.core.trainer import Trainer

    cfg = Config(overrides=_slice_config(name)).get_config_dict()
    trainer = Trainer(cfg, device=dev)
    state = trainer.state
    frozen0 = {k: v.clone() for k, v in _frozen(state).items()}
    params0 = {k: v.clone() for k, v in state.params.state_dict().items()}
    losses = []
    trainer.epoch_hook = lambda t, e, s, step_losses: losses.append(np.asarray(step_losses))

    _reset_launches()
    with _recorded_shapes(seen):
        res = trainer.train_loop()
    torch.cuda.synchronize()
    launches = _launches()

    steps = sum(len(x) for x in losses)
    table = res["acc_table"]
    sizes = [len(trainer.train_stream.task(t)) for t in range(2)]
    print(f"[slice {name}] task sizes {sizes}, {steps} train steps, "
          f"losses {np.concatenate(losses).round(4).tolist()}")
    print(f"[slice {name}] acc table {table.tolist()}, last avg acc {res['last_avg_acc']}")
    print(f"[slice {name}] kernel launches in the run: {launches}")
    _require(steps > 0 and all(np.isfinite(x).all() for x in losses), f"{name}: non-finite loss")
    _require(table.shape == (2, 2) and np.isfinite(table).all(), f"{name}: acc table not filled")
    frozen1 = _frozen(trainer.state)
    _require(len(frozen0) > 0 and all(torch.equal(v, frozen1[k]) for k, v in frozen0.items()),
             f"{name}: frozen backbone changed")
    params1 = trainer.state.params.state_dict()
    for pname in TRAINED[name]:
        _require(not torch.equal(params0[pname], params1[pname]), f"{name}: {pname} did not train")
    if name in CLIP_CONFIGS:
        return trainer, launches, steps, _clip_slice_launches(trainer, name, launches, steps)
    depth = len(trainer.state.mvars["frozen"].blocks)  # 12 at ViT-B/16
    _require(depth == 12 and trainer.method.embed_dim == 768, f"{name}: not ViT-B/16 width")
    if name in ("DualPrompt", "CodaPrompt"):
        # per step: the query pass (12 blocks) and the prefixed pass (5 prefix
        # blocks, 7 plain) forward; the prefixed pass backward
        minimum = {"qkv_fwd": (2 * depth - PREFIX_BLOCKS) * steps,
                   "pqkv_fwd": PREFIX_BLOCKS * steps,
                   "qkv_bwd": (depth - PREFIX_BLOCKS) * steps,
                   "pqkv_bwd": PREFIX_BLOCKS * steps}
    elif name == "DAP":  # two prompted passes, forward and backward
        minimum = {"qkv_fwd": 2 * depth * steps, "qkv_bwd": 2 * depth * steps}
    else:  # L2P: the query pass and the prompted pass forward, one backward
        minimum = {"qkv_fwd": 2 * depth * steps, "qkv_bwd": depth * steps}
    for k, n in minimum.items():
        _require(launches[k] >= n, f"{name}: {k} launched {launches[k]} times, fewer than {n}")
    return trainer, launches, steps, None


def _frozen(state) -> dict:
    """The backbone tensors that must not move: the prompt methods' and
    RAPF's frozen module, or MoE-Adapter4CL's parameters outside its split."""
    if "frozen" in state.mvars:
        return state.mvars["frozen"].state_dict()
    return {n: p for n, p in state.params.named_parameters() if not p.requires_grad}


def _clip_model(trainer):
    state = trainer.state
    return state.mvars["frozen"] if "frozen" in state.mvars else state.params["clip"]


def _clip_slice_launches(trainer, name, launches, steps):
    """Checks the full CLIP width and the launch counts of a CLIP slice.
    MoE-Adapter4CL: per step 12 forwards of each tower and 11 backwards (the
    first block's attention input depends on frozen weights only), plus the
    eval's forwards. RAPF: the frozen text tower once per task (its text
    features), the frozen vision tower forward only."""
    clip = _clip_model(trainer)
    text = clip.text
    width = (clip.visual.embed_dim, text.token_embedding.shape[1], clip.embed_dim)
    geometry = (len(clip.visual.blocks), len(text.blocks), text.blocks[0].attn.num_heads,
                tuple(text.token_embedding.shape), text.pos_embed.shape[0])
    print(f"[slice {name}] CLIP widths (vision, text, embed) {width}, (vision depth, text depth, "
          f"text heads, vocab x width, context) {geometry}, trainable parameters "
          f"{sum(p.numel() for p in trainer.method.trainable_parameters(trainer.state))}")
    _require(width == (768, 512, 512) and geometry == (12, 12, 8, (49408, 512), 77),
             f"{name}: not full CLIP width")
    tasks = 2
    if name == "RAPF":
        exact = {"qkv_bwd": 0, "mqkv_fwd": 12 * tasks, "mqkv_bwd": 0}
        minimum = {"qkv_fwd": 12 * steps}
    else:
        _require(clip.visual.blocks[0].moe.num_experts == 4, f"{name}: not 4 experts")
        exact = {"qkv_bwd": 11 * steps, "mqkv_bwd": 11 * steps}
        minimum = {"qkv_fwd": 12 * steps, "mqkv_fwd": 12 * steps}
    for k, n in exact.items():
        _require(launches[k] == n, f"{name}: {k} launched {launches[k]} times, not {n}")
    for k, n in minimum.items():
        _require(launches[k] >= n, f"{name}: {k} launched {launches[k]} times, fewer than {n}")
    return exact


class _PlainQKV(torch.autograd.Function):
    """The plain forward and backward as one autograd function, for the
    kernels-vs-plain comparison of a whole batch."""

    @staticmethod
    def forward(ctx, qkv, scale, heads):
        A = _attention_modules()[0]
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.heads = scale, heads
        return A.qkv_attention_plain(qkv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        A = _attention_modules()[0]
        (qkv,) = ctx.saved_tensors
        return A.qkv_attention_bwd_plain(qkv, g.contiguous(), ctx.scale, ctx.heads), None, None


class _PlainPrefix(torch.autograd.Function):
    """The plain prefix-KV forward and backward as one autograd function."""

    @staticmethod
    def forward(ctx, qkv, pk, pv, scale, heads):
        PA = _attention_modules()[1]
        ctx.save_for_backward(qkv, pk, pv)
        ctx.scale, ctx.heads = scale, heads
        return PA.prefix_attention_plain(qkv, pk, pv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        PA = _attention_modules()[1]
        qkv, pk, pv = ctx.saved_tensors
        grads = PA.prefix_attention_bwd_plain(qkv, pk, pv, g.contiguous(), ctx.scale, ctx.heads)
        return (*grads, None, None)


class _PlainMasked(torch.autograd.Function):
    """The plain masked forward and backward as one autograd function."""

    @staticmethod
    def forward(ctx, qkv, mask, scale, heads):
        MA = _attention_modules()[2]
        ctx.save_for_backward(qkv, mask)
        ctx.scale, ctx.heads = scale, heads
        return MA.masked_attention_plain(qkv, mask, scale, heads)

    @staticmethod
    def backward(ctx, g):
        MA = _attention_modules()[2]
        qkv, mask = ctx.saved_tensors
        dqkv = MA.masked_attention_bwd_plain(qkv, mask, g.contiguous(), ctx.scale, ctx.heads)
        return dqkv, None, None, None


_PLAIN = {"fused_qkv_attention": _PlainQKV.apply, "fused_prefix_attention": _PlainPrefix.apply,
          "fused_masked_qkv_attention": _PlainMasked.apply}


@contextlib.contextmanager
def _plain_attention():
    """Within it, the ViT block's attention calls (plain, with a prefix, with
    a mask) go to the plain versions."""
    from libcontinual_tpu_torch.models import vit

    saved = {name: getattr(vit, name) for name in _PLAIN}
    for name, fn in _PLAIN.items():
        setattr(vit, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(vit, name, fn)


def _compare(tag, got: dict, ref: dict, tol=SLICE_TOL):
    for name, a in got.items():
        b = ref[name]
        scaled = float((a - b).norm() / b.norm())
        print(f"[slice ref {tag}] {name}: relative L2 error {scaled:.3e} (tolerance {tol})")
        _require(torch.isfinite(a).all() and scaled <= tol, f"{tag}: {name} disagree")


def _direction(dev, dim):
    """A fixed random direction of the features. The whole-batch checks take
    the gradient of the features' projection on it: a CLS readout leaves the
    final LayerNorm with a norm that does not depend on the input, so the
    gradient of sum(features ** 2) would be zero."""
    return torch.randn(dim, device=dev, generator=torch.Generator(device=dev).manual_seed(3))


def phase_slice_reference(trainer, dev, name):
    """One full-width batch through the trained L2P or DAP state's prompted
    pass (and L2P's query pass), with the kernels and with the plain
    attention: the features and the prompt gradient agree. The prompts are
    fixed (L2P: pool entries 0..k-1; DAP: the general prompt, which its
    evaluation uses), so no discrete choice sits between the two runs."""
    state, method = trainer.state, trainer.method
    td = trainer.test_stream.task(0)
    x = method.augment(None, torch.from_numpy(td.images[:8]).to(dev), train=False)
    frozen = state.mvars["frozen"]
    depth = len(frozen.blocks)
    u = _direction(dev, method.embed_dim)
    param = (state.params["prompt"].prompt if name == "L2P"
             else state.params["prompt"]["generalprompt"])

    def run():
        param.grad = None
        res = {}
        if name == "L2P":
            res["query features"] = method.frozen_query(frozen, x).detach()
            prompts = param[: method.top_k].reshape(1, -1, param.shape[-1])
        else:
            prompts = param[None]
        out = frozen(x, prepend_tokens=prompts.expand(x.shape[0], -1, -1),
                     feature_mode="prompt_mean")
        (out["features"].float() @ u).sum().backward()
        res["prompted features"] = out["features"].detach()
        res["prompt grad"] = param.grad.detach().clone()
        return res

    _reset_launches()
    got = run()
    launches = _launches()
    passes = 2 if name == "L2P" else 1
    _require(launches["qkv_fwd"] == passes * depth and launches["qkv_bwd"] == depth,
             f"{name} reference run launched {launches}")
    with _plain_attention():
        ref = run()
    _compare(name, got, ref)


def _as_f32(vit):
    vit = copy.deepcopy(vit).float()
    for m in vit.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    return vit


def phase_prefix_slice_reference(trainer, dev):
    """One full-width batch through the trained DualPrompt state, with the
    kernels and with the plain attention (both kinds): query features,
    prefixed features and the gradients of every prompt agree, in the
    compute dtype (bf16) and with the ViT in f32. The prefixes are the
    training ones (the current task's e-prompt for every image), so no
    discrete choice sits between the two runs."""
    state, method = trainer.state, trainer.method
    td = trainer.test_stream.task(state.task)
    x = method.augment(None, torch.from_numpy(td.images[:16]).to(dev), train=False)
    prompt = state.params["prompt"]
    u = _direction(dev, method.embed_dim)

    def run(frozen):
        prompt.zero_grad(set_to_none=True)
        q = method.frozen_query(frozen, x)
        prefix_kv, _ = method.prefixes(prompt, q, state.task, train=True)
        out = frozen(x, prefix_kv=prefix_kv)
        (out["features"].float() @ u).sum().backward()
        grads = torch.cat([p.grad.flatten() for p in prompt.values() if p.grad is not None])
        return {"query features": q.detach(), "prefixed features": out["features"].detach(),
                "prompt grad": grads}

    for tag, frozen, tol in (("DualPrompt", state.mvars["frozen"], SLICE_TOL),
                             ("DualPrompt f32", _as_f32(state.mvars["frozen"]), SLICE_TOL_F32)):
        _reset_launches()
        got = run(frozen)
        launches = _launches()
        _require(launches["pqkv_fwd"] == PREFIX_BLOCKS and launches["pqkv_bwd"] == PREFIX_BLOCKS,
                 f"{tag} reference run launched {launches}")
        with _plain_attention():
            ref = run(frozen)
        _compare(tag, got, ref, tol)


def _moe_choices(clip):
    """Within it, every MoEMLP call appends (tower, each row's top-k experts)
    to the returned list, recomputed from its gate input and router (the
    reference runs draw no noise)."""
    from libcontinual_tpu_torch.models.vit import MoEMLP

    choices, handles = [], []
    for tower, mod in (("visual", clip.visual), ("text", clip.text)):
        for m in mod.modules():
            if isinstance(m, MoEMLP):
                def hook(m, args, out, tower=tower):
                    logits = args[1].float() @ m.w_gate.float()
                    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices
                    choices.append((tower, top[:, : m.top_k].sort(dim=-1).values.detach()))
                handles.append(m.register_forward_hook(hook))
    return choices, handles


def phase_clip_reference(trainer, dev):
    """One full-width batch through the trained MoE-Adapter4CL state (16
    images against the prompts of all 100 classes), with the kernels and
    with the plain attention: image and text features, logits, and the
    gradient of a fixed random projection of the logits with respect to the
    MoE leaves and ``logit_scale`` (the features are unit vectors, so a sum
    of their squares would be constant), in bf16 and with the CLIP in f32;
    and the share of images and prompts whose top-k experts agree in every
    block between the two runs."""
    state, method = trainer.state, trainer.method
    td = trainer.test_stream.task(state.task)
    x = method.augment(None, torch.from_numpy(td.images[:16]).to(dev), train=False)
    tokens = state.mvars["task_tokens"]
    u = torch.randn(16, tokens.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))

    def run(clip):
        leaves = [p for p in clip.parameters() if p.requires_grad]
        for p in leaves:
            p.grad = None
        choices, handles = _moe_choices(clip)
        try:
            out = clip(x, tokens)
            (out["logits_per_image"] * u).sum().backward()
        finally:
            for h in handles:
                h.remove()
        grads = torch.cat([p.grad.flatten() for p in leaves if p.grad is not None])
        res = {k: out[k].detach() for k in ("image_features", "text_features", "logits_per_image")}
        res["MoE and logit_scale grad"] = grads
        return res, choices

    for tag, clip, tol in (("MoE_Adapter4CL", state.params["clip"], SLICE_TOL),
                           ("MoE_Adapter4CL f32", _as_f32(state.params["clip"]), SLICE_TOL_F32)):
        _reset_launches()
        got, got_choice = run(clip)
        launches = _launches()
        want = {"qkv_fwd": 12, "qkv_bwd": 11, "mqkv_fwd": 12, "mqkv_bwd": 11}
        _require(all(launches[k] == n for k, n in want.items()),
                 f"{tag} reference run launched {launches}")
        with _plain_attention():
            ref, ref_choice = run(clip)
        agree = {}
        for tower in ("visual", "text"):
            a = [c for t, c in got_choice if t == tower]
            b = [c for t, c in ref_choice if t == tower]
            same = torch.stack([(p == q).all(dim=-1) for p, q in zip(a, b)]).all(dim=0)
            agree[tower] = f"{int(same.sum())}/{same.numel()}"
        print(f"[slice ref {tag}] rows whose top-k experts agree in all 12 blocks, kernels vs "
              f"plain: images {agree['visual']}, prompts {agree['text']}")
        _compare(tag, got, ref, tol)


def _icarl_config(task_num):
    """``ICARL_CONFIG`` cut to ``task_num`` tasks of 10 classes."""
    cfg = copy.deepcopy(ICARL_CONFIG)
    cfg["task_num"] = task_num
    cfg["classifier"]["kwargs"].update(num_class=10 * task_num, task_num=task_num)
    return cfg


def _stride1_3x3_convs(backbone):
    """(name, module) of every stride-1 3x3 convolution: the CIFAR stem and,
    in each block, both convolutions but a downsampling block's first."""
    from libcontinual_tpu_torch.models.resnet import Conv

    return [(n, m) for n, m in backbone.named_modules()
            if isinstance(m, Conv) and m.weight.shape[-1] == 3 and m.stride == 1]


def phase_icarl_slice(dev):
    """iCaRL through the trainer on a full-width resnet18 (CIFAR stem, bf16,
    batch 128, herding buffer 200), cut to 2 tasks of 10 classes and 2
    epochs: task 1 trains on its images and the buffer, with KD against the
    task-0 teacher, and evaluates by NME. The ResNet's convolutions are
    cuDNN's, as the JAX ResNet's are XLA's, so the run launches no kernel of
    the port."""
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.core.trainer import Trainer

    cfg = Config(overrides=_icarl_config(2)).get_config_dict()
    trainer = Trainer(cfg, device=dev)
    backbone = trainer.state.params["backbone"]
    n_params = sum(p.numel() for p in backbone.parameters())
    print(f"[slice iCaRL] resnet18: CIFAR stem {backbone.cifar_stem}, widths "
          f"{[blk.bn1.weight.numel() for blk in backbone.blocks]}, {n_params} backbone parameters")
    _require(backbone.cifar_stem and n_params == RESNET18_CIFAR_PARAMS
             and trainer.method.feat_dim == 512, "iCaRL: not the full-width CIFAR resnet18")
    params0 = {k: v.clone() for k, v in trainer.state.params.state_dict().items()}
    losses = []
    trainer.epoch_hook = lambda t, e, s, step_losses: losses.append(np.asarray(step_losses))
    _reset_launches()
    t0 = time.perf_counter()
    res = trainer.train_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()

    state, buf = trainer.state, trainer.buffer
    counts = np.bincount(buf.labels, minlength=20).tolist()
    steps = [len(x) for x in losses]
    table = res["acc_table"]
    print(f"[slice iCaRL] {sum(steps)} train steps {steps} in {wall:.1f} s, losses "
          f"{np.concatenate(losses).round(4).tolist()}")
    print(f"[slice iCaRL] acc table {table.tolist()}, last avg acc {res['last_avg_acc']}")
    print(f"[slice iCaRL] buffer: {len(buf)} exemplars, per class {counts}; NME ready "
          f"{state.mvars['nme_ready']}, class means for "
          f"{int(state.mvars['mean_valid'].sum())} classes")
    print(f"[slice iCaRL] kernel launches in the run: {launches}")
    _require(all(np.isfinite(x).all() for x in losses), "iCaRL: non-finite loss")
    # 600 images, then 600 + 200 exemplars, in batches of 128, 2 epochs each
    _require(steps == [5, 5, 7, 7], f"iCaRL: steps {steps}")
    _require(table.shape == (2, 2) and np.isfinite(table).all(), "iCaRL: acc table not filled")
    _require(counts == [10] * 20, "iCaRL: the herding buffer is not 10 exemplars a class")
    _require(state.mvars["nme_ready"] and int(state.mvars["mean_valid"].sum()) == 20,
             "iCaRL: class means do not cover the 20 classes")
    params1 = state.params.state_dict()
    for pname in ("head.dense.weight", "backbone.conv_stem.weight",
                  "backbone.blocks.7.conv1.weight", "backbone.bn_stem.running_mean"):
        _require(not torch.equal(params0[pname], params1[pname]), f"iCaRL: {pname} did not move")
    _require(not any(launches.values()), f"iCaRL: the ResNet launched a kernel: {launches}")
    return trainer


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_icarl_conv_path(trainer, dev, seen):
    """One training batch of 128 through the trained iCaRL network's loss
    (CE and KD at task 1): hooks capture the input and the output gradient
    of each of its 14 stride-1 3x3 convolutions. ``conv3x3`` (forward, and
    backward through autograd: the forward kernel for dx, the dw kernel)
    then recomputes y, dx and dw of each; they agree with the modules' own
    cuDNN results. Returns this run's launch counts: exactly 2 forward-kernel
    launches and 1 dw launch a convolution."""
    C = _conv_module()
    state, method = trainer.state, trainer.method
    convs = _stride1_3x3_convs(state.params["backbone"])
    _require(len(convs) == 14, f"resnet18 has {len(convs)} stride-1 3x3 convolutions, not 14")
    td = trainer.train_stream.task(state.task)
    batch = {"image": torch.from_numpy(td.images[:128]).to(dev),
             "label": torch.from_numpy(td.labels[:128].astype(np.int64)).to(dev),
             "weight": torch.ones(128, device=dev)}
    batch["x"] = method.augment(state.rng, batch["image"], train=True)
    captured, handles = {}, []
    for name, mod in convs:
        def hook(mod, args, out, name=name):
            cap = captured[name] = {"x": args[0].detach().to(mod.dtype), "y": out.detach()}
            out.register_hook(lambda g: cap.__setitem__("g", g.detach()))
        handles.append(mod.register_forward_hook(hook))
    try:
        loss, _ = method.loss(state, batch)
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    state.params.zero_grad(set_to_none=True)

    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
    outs = []
    _reset_launches()
    with _recorded_shapes(seen):
        for name, mod in convs:
            cap = captured[name]
            x = nhwc(cap["x"]).requires_grad_()
            w = mod.weight.detach().permute(2, 3, 1, 0).contiguous().requires_grad_()  # HWIO f32
            y = C.conv3x3(x, w)
            y.backward(nhwc(cap["g"]))
            outs.append((y.detach(), x.grad, w.grad))
    torch.cuda.synchronize()
    launches = _launches()
    print(f"[conv path] launches for the 14 convolutions: {launches}")
    _require(launches["conv3x3_fwd"] == 28 and launches["conv3x3_dw"] == 14
             and sum(launches.values()) == 42, f"conv path launched {launches}")

    worst = {"y": 0.0, "dx": 0.0, "dw": 0.0}
    for (name, mod), (y, dx, dw) in zip(convs, outs):
        cap = captured[name]
        wb = mod.weight.detach().to(mod.dtype)
        dx_ref, dw_ref, _ = torch.ops.aten.convolution_backward(
            cap["g"], cap["x"], wb, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])
        err = {"y": _rel_l2(y, nhwc(cap["y"])), "dx": _rel_l2(dx, nhwc(dx_ref)),
               "dw": _rel_l2(dw, dw_ref.permute(2, 3, 1, 0))}
        b, h, w_, c = cap["x"].shape[0], *cap["x"].shape[2:], cap["x"].shape[1]
        print(f"[conv path] {name} ({b}x{h}x{w_}x{c} -> {mod.weight.shape[0]}): relative L2 "
              f"against cuDNN y {err['y']:.3e}, dx {err['dx']:.3e}, dw {err['dw']:.3e} "
              f"(tolerance {CONV_PATH_TOL})")
        for k, v in err.items():
            worst[k] = max(worst[k], v)
            _require(np.isfinite(v) and v <= CONV_PATH_TOL, f"conv path {name}: {k} disagrees")
    print(f"[conv path] worst relative L2 over the 14 convolutions: {worst}")
    return launches


@contextlib.contextmanager
def _captured_attention(blocks: list):
    """Within it, every packed-qkv and prefix attention call of the ViT
    appends its block's qkv, pk and pv (or None), scale and heads to
    ``blocks``, and the output's gradient under "g" once the backward has
    run; the calls themselves run as before."""
    from libcontinual_tpu_torch.models import vit

    names = ("fused_qkv_attention", "fused_prefix_attention")
    saved = {n: getattr(vit, n) for n in names}

    def record(out, qkv, pk, pv, scale, heads):
        blk = {"qkv": qkv.detach(), "pk": pk, "pv": pv, "scale": scale, "heads": heads}
        out.register_hook(lambda g: blk.__setitem__("g", g.detach()))
        blocks.append(blk)
        return out

    def qkv_call(qkv, scale, heads):
        return record(saved["fused_qkv_attention"](qkv, scale, heads), qkv, None, None, scale,
                      heads)

    def prefix_call(qkv, pk, pv, scale, heads):
        out = saved["fused_prefix_attention"](qkv, pk, pv, scale, heads)
        return record(out, qkv, pk.detach(), pv.detach(), scale, heads)

    vit.fused_qkv_attention, vit.fused_prefix_attention = qkv_call, prefix_call
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(vit, n, fn)


def capture_generic_path(trainer, dev, name, seen):
    """One batch of 128 random 32 px images through the trained state at
    bf16, forward and backward (the gradient of a fixed random projection of
    the features): L2P's prompted pass (pool entries 0..k-1 prepended, S
    222) or DualPrompt's prefixed pass (the training prefixes; blocks 0-4
    with prompt keys and values, Skv 200 and 207). Returns its 12 blocks'
    captured attention inputs and output gradients."""
    state, method = trainer.state, trainer.method
    frozen = state.mvars["frozen"]
    imgs = np.random.RandomState(11).randint(0, 255, (128, 32, 32, 3)).astype(np.uint8)
    x = method.augment(None, torch.from_numpy(imgs).to(dev), train=False)
    u = _direction(dev, method.embed_dim)
    blocks = []
    with _recorded_shapes(seen):
        if name == "L2P":
            param = state.params["prompt"].prompt
            prompts = param[: method.top_k].reshape(1, -1, param.shape[-1])
            with _captured_attention(blocks):
                out = frozen(x, prepend_tokens=prompts.expand(x.shape[0], -1, -1),
                             feature_mode="prompt_mean")
        else:
            prompt = state.params["prompt"]
            q = method.frozen_query(frozen, x)
            prefix_kv, _ = method.prefixes(prompt, q, state.task, train=True)
            with _captured_attention(blocks):
                out = frozen(x, prefix_kv=prefix_kv)
        (out["features"].float() @ u).sum().backward()
    torch.cuda.synchronize()
    state.params.zero_grad(set_to_none=True)
    _require(len(blocks) == 12 and all("g" in blk for blk in blocks),
             f"{name}: captured {len(blocks)} attention blocks")
    shapes = [(blk["qkv"].shape[1], None if blk["pk"] is None else blk["pk"].shape[1])
              for blk in blocks]
    print(f"[generic path] {name}: captured {len(blocks)} blocks of a batch of 128, "
          f"(S, P) {shapes}")
    return blocks


def _to_heads(t, heads):
    """(B, N, D) -> a (B, H, N, hd) view."""
    b, n, d = t.shape
    return t.view(b, n, heads, d // heads).transpose(1, 2)


def _from_heads(t):
    """(B, H, N, hd) -> (B, N, D)."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def phase_generic_path(captures, dev, seen):
    """Each captured block's q, k and v through ``fused_attention``, forward
    and backward with the block's own output gradient: q, and k and v
    without a prefix, are (B, H, S, hd) views of the packed qkv (no copy); a
    prefix block's pk and pv go in front of its keys and values, as the JAX
    ViT's general path puts them (``models/vit.py:180-185``). The output and
    dq, dk, dv agree with the packed and prefix kernels' own results on the
    same block. Returns this run's launch counts: one ``attn_fwd`` a block."""
    A, PA, _ = _attention_modules()
    blocks = [blk for name in ("L2P", "DualPrompt") for blk in captures[name]]
    refs = []
    for blk in blocks:  # the packed and prefix kernels, forward and backward
        qkv, g, h, scale = blk["qkv"], blk["g"], blk["heads"], blk["scale"]
        d = qkv.shape[-1] // 3
        x = qkv.clone().requires_grad_()
        if blk["pk"] is None:
            o = A.fused_qkv_attention(x, scale, h)
            o.backward(g)
            dk, dv = x.grad[..., d:2 * d], x.grad[..., 2 * d:]
        else:
            pk, pv = (t.clone().requires_grad_() for t in (blk["pk"], blk["pv"]))
            o = PA.fused_prefix_attention(x, pk, pv, scale, h)
            o.backward(g)
            dk = torch.cat([pk.grad, x.grad[..., d:2 * d]], dim=1)
            dv = torch.cat([pv.grad, x.grad[..., 2 * d:]], dim=1)
        refs.append((o.detach(), x.grad[..., :d], dk, dv))

    _reset_launches()
    outs = []
    with _recorded_shapes(seen):
        for blk in blocks:
            qkv, g, h, scale = blk["qkv"], blk["g"], blk["heads"], blk["scale"]
            d = qkv.shape[-1] // 3
            k, v = qkv[..., d:2 * d], qkv[..., 2 * d:]
            if blk["pk"] is not None:
                k, v = torch.cat([blk["pk"], k], dim=1), torch.cat([blk["pv"], v], dim=1)
            q, k, v = (_to_heads(t, h).detach().requires_grad_() for t in (qkv[..., :d], k, v))
            o = A.fused_attention(q, k, v, scale)
            o.backward(_to_heads(g, h))
            outs.append(tuple(_from_heads(t) for t in (o.detach(), q.grad, k.grad, v.grad)))
    torch.cuda.synchronize()
    launches = _launches()
    print(f"[generic path] launches for the 24 blocks: {launches}")
    _require(launches["attn_fwd"] == len(blocks) == 24 and sum(launches.values()) == 24,
             f"generic path launched {launches}")

    worst = dict.fromkeys(("output", "dq", "dk", "dv"), 0.0)
    for i, (blk, got, ref) in enumerate(zip(blocks, outs, refs)):
        err = {n: _rel_l2(a, r) for n, a, r in zip(worst, got, ref)}
        tag = (f"{'L2P' if i < 12 else 'DualPrompt'} block {i % 12} (Sq {blk['qkv'].shape[1]}, "
               f"Skv {got[2].shape[1]})")
        print(f"[generic path] {tag}: relative L2 against the "
              f"{'packed' if blk['pk'] is None else 'prefix'} kernels: " + ", ".join(
                  f"{n} {e:.3e}" for n, e in err.items()) + f" (tolerance {GENERIC_PATH_TOL})")
        for n, e in err.items():
            worst[n] = max(worst[n], e)
            _require(np.isfinite(e) and e <= GENERIC_PATH_TOL, f"generic path {tag}: {n} disagrees")
    print(f"[generic path] worst relative L2 over the 24 blocks: {worst}")
    return launches


def _time_cuda(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _heads(t, heads):
    """(B, N, D) -> contiguous (B, H, N, hd), SDPA's layout."""
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2).contiguous()


def _bound(nbytes, flops):
    """(least ms, what bounds it): bytes over HBM bandwidth against bf16
    operations over the tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _pqkv_bounds(b, s, p, d, h):
    """(forward, backward) bounds of the prefix kernels in bf16: read qkv,
    pk, pv (and g), write o (or dqkv, dpk, dpv), each once."""
    per_image = s * 3 * d + 2 * p * d + s * d
    flops = 2 * b * h * s * (s + p) * (d // h)  # one product over S x (S + P)
    return (_bound(2 * b * per_image, 2 * flops),
            _bound(2 * b * (per_image + s * 3 * d + 2 * p * d), 5 * flops))


def _time_pair(label, runs, card, library="sdpa"):
    """``runs`` maps plain, library (SDPA or cuDNN), any other yardstick and
    kernel to a function, in that order; each is timed twice, in that order
    and then in reverse, and the better of the two is kept."""
    order = list(runs) + list(runs)[::-1]
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(_time_cuda(runs[k]))
    best = {k: min(v) for k, v in times.items()}
    others = "".join(f", {k} {best[k]:.4f} ms" for k in runs
                     if k not in ("kernel", "plain", "library"))
    lib = f", {library} {best['library']:.4f} ms" if "library" in best else ""
    if not lib and not others:
        lib = f", no {library} call"
    print(f"[timing] {label}: kernel {best['kernel']:.4f} ms, plain {best['plain']:.4f} ms"
          f"{lib}{others} (all runs "
          f"{json.dumps({k: [round(x, 4) for x in v] for k, v in times.items()})}) [{card}]")
    return best


def _sdpa_runs(q, k, v, go_h, scale, backends, **mask):
    """{name: (forward, forward + backward)} of SDPA on each of ``backends``
    ({name: SDPBackend, or None for PyTorch's own choice}) that takes these
    inputs (the others are reported and left out); inputs built outside the
    timed window. ``go_h`` None: the forward alone (forward + backward is
    None). ``mask``: SDPA's ``attn_mask`` or ``is_causal``."""
    from torch.nn.attention import sdpa_kernel

    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    runs = {}
    for name, backend in backends.items():
        def within(fn, backend=backend):
            def call():
                with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
                    return fn()
            return call

        fwd = within(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale, **mask))
        fwd_bwd = within(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, scale=scale, **mask), (qg, kg, vg), go_h))
        if go_h is None:
            fwd_bwd = None
        try:
            fwd()
            if fwd_bwd is not None:
                fwd_bwd()
            torch.cuda.synchronize()
            runs[name] = (fwd, fwd_bwd)
        except RuntimeError as e:
            print(f"[timing] {name} does not take B {q.shape[0]} H {q.shape[1]} Sq {q.shape[2]} "
                  f"Skv {k.shape[2]} hd {q.shape[3]} {sorted(mask)}: "
                  f"{str(e).splitlines()[0][:120]}")
    return runs


def _flash_and_cudnn():
    from torch.nn.attention import SDPBackend

    return {"sdpa_flash": SDPBackend.FLASH_ATTENTION, "sdpa_cudnn": SDPBackend.CUDNN_ATTENTION}


def _set_library(best, names):
    """``best["library"]`` and ``best["library_name"]``: the time and the
    name of the fastest of the SDPA runs ``names`` (None without one)."""
    fastest = min(names, key=best.get) if names else None
    best["library"] = best[fastest] if fastest else None
    best["library_name"] = fastest


def _device_us(evt) -> float:
    """Device time of one ``key_averages`` row, in microseconds."""
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def _bwd_split(fn, calls=10):
    """{"dq": ms, "dkdv": ms}: the device time a call of ``fn`` (a backward
    wrapper) spends in each of its two kernels, from a ``torch.profiler``
    trace of ``calls`` calls after warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {"dq": 0.0, "dkdv": 0.0}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            for k in split:
                if f"attn_bwd_{k}_kernel" in evt.key:
                    split[k] += _device_us(evt) / 1e3 / calls
    return split


def _time_family(name, tag, kernels, plains, sdpa, card):
    """The forward and backward kernels of one family (``kernels`` and
    ``plains``: (forward, backward) functions) beside their plain versions
    and every SDPA run of ``sdpa`` ({name: (forward, forward + backward)}),
    each timed by ``_time_pair``; SDPA's backward is its forward + backward
    minus its forward; the backward's two kernels apart by ``_bwd_split``.
    Returns the forward's and the backward's best times, each with the
    fastest SDPA time under "library" and its name under "library_name"
    (the backward also its kernels' under "dq" and "dkdv")."""
    fwd = _time_pair(f"{name}_fwd at {tag}", {
        "plain": plains[0], **{n: f for n, (f, _) in sdpa.items()}, "kernel": kernels[0]}, card)
    bwd = _time_pair(f"{name}_bwd at {tag} (SDPA: forward + backward)", {
        "plain": plains[1], **{n: fb for n, (_, fb) in sdpa.items()}, "kernel": kernels[1]}, card)
    for n in sdpa:
        bwd[n] -= fwd[n]
    print(f"[timing] {name}_bwd SDPA backward alone (forward + backward minus forward): "
          + ", ".join(f"{n} {bwd[n]:.4f} ms" for n in sdpa) + f" [{card}]")
    bwd.update(_bwd_split(kernels[1]))
    print(f"[timing] {name}_bwd kernels apart (torch.profiler, 10 calls): attn_bwd_dq_kernel "
          f"{bwd['dq']:.4f} ms, attn_bwd_dkdv_kernel {bwd['dkdv']:.4f} ms, together "
          f"{bwd['dq'] + bwd['dkdv']:.4f} ms; the whole call {bwd['kernel']:.4f} ms (CUDA "
          f"events) [{card}]")
    for best in (fwd, bwd):
        _set_library(best, list(sdpa))
    return fwd, bwd


def _mqkv_bounds(b, s, d, h):
    """(forward, backward) bounds of the masked kernels in bf16: read qkv
    (and g) and the f32 mask, write o (or dqkv), each once."""
    per_image = s * 3 * d + s * d
    flops = 2 * b * h * s * s * (d // h)  # one product over S x S
    return (_bound(2 * b * per_image + 4 * s * s, 2 * flops),
            _bound(2 * b * (per_image + s * 3 * d) + 4 * s * s, 5 * flops))


def phase_kernel_timing(dev, card):
    """The packed, prefix and masked kernels, forward and backward, at the
    main path's timed shapes (bf16), beside plain, SDPA on the flash and
    cuDNN backends (the masked family: with ``is_causal``, and PyTorch's own
    choice with the float mask) and the bound. Returns {kernels-line name:
    (best times, bound)}."""
    A, PA, MA = _attention_modules()
    out = {}
    # packed qkv at the L2P prompted pass
    b, s, d, h = TIMED
    scale = (d // h) ** -0.5
    qkv, go = _inputs(TIMED, torch.bfloat16, dev, seed=7)
    q, k, v = (_heads(qkv[..., i * d:(i + 1) * d], h) for i in range(3))
    sdpa = _sdpa_runs(q, k, v, _heads(go, h), scale, _flash_and_cudnn())
    fwd, bwd = _time_family("qkv", f"B {b} S {s} D {d} H {h} bf16", (
        lambda: A.qkv_attention_cuda(qkv, scale, h),
        lambda: A.qkv_attention_bwd_cuda(qkv, go, scale, h)), (
        lambda: A.qkv_attention_plain(qkv, scale, h),
        lambda: A.qkv_attention_bwd_plain(qkv, go, scale, h)), sdpa, card)
    per_image = s * 3 * d + s * d
    out["qkv_fwd"] = (fwd, _bound(2 * b * per_image, 4 * b * h * s * s * (d // h)))
    out["qkv_bwd"] = (bwd, _bound(2 * b * (per_image + s * 3 * d), 10 * b * h * s * s * (d // h)))
    del qkv, go, q, k, v, sdpa

    # prefix-KV at the DualPrompt e-prompt blocks
    b, s, p, d, h = P_TIMED
    scale = (d // h) ** -0.5
    qkv, pk, pv, go = _prefix_inputs(P_TIMED, torch.bfloat16, dev, seed=8, layout="image")
    pk, pv = pk.contiguous(), pv.contiguous()
    q = _heads(qkv[..., :d], h)
    k = _heads(torch.cat([pk, qkv[..., d:2 * d]], dim=1), h)
    v = _heads(torch.cat([pv, qkv[..., 2 * d:]], dim=1), h)
    sdpa = _sdpa_runs(q, k, v, _heads(go, h), scale, _flash_and_cudnn())
    fwd, bwd = _time_family("pqkv", f"B {b} S {s} P {p} D {d} H {h} bf16", (
        lambda: PA.prefix_attention_cuda(qkv, pk, pv, scale, h),
        lambda: PA.prefix_attention_bwd_cuda(qkv, pk, pv, go, scale, h)), (
        lambda: PA.prefix_attention_plain(qkv, pk, pv, scale, h),
        lambda: PA.prefix_attention_bwd_plain(qkv, pk, pv, go, scale, h)), sdpa, card)
    bound_fwd, bound_bwd = _pqkv_bounds(b, s, p, d, h)
    out["pqkv_fwd"], out["pqkv_bwd"] = (fwd, bound_fwd), (bwd, bound_bwd)
    del qkv, pk, pv, go, q, k, v, sdpa

    # masked at the CLIP text tower of a MoE-Adapter4CL step (100 prompts)
    b, s, d, h = M_TIMED
    scale = (d // h) ** -0.5
    qkv, mask, go = _masked_inputs(M_TIMED, torch.bfloat16, dev, seed=9, kind="causal")
    q, k, v = (_heads(qkv[..., i * d:(i + 1) * d], h) for i in range(3))
    go_h = _heads(go, h)
    sdpa = _sdpa_runs(q, k, v, go_h, scale, _flash_and_cudnn(), is_causal=True)
    sdpa.update(_sdpa_runs(q, k, v, go_h, scale, {"sdpa_float_mask": None},
                           attn_mask=mask.to(torch.bfloat16)))
    fwd, bwd = _time_family("mqkv", f"B {b} S {s} D {d} H {h} bf16 causal (SDPA flash and "
                            "cuDNN: is_causal)", (
        lambda: MA.masked_attention_cuda(qkv, mask, scale, h),
        lambda: MA.masked_attention_bwd_cuda(qkv, mask, go, scale, h)), (
        lambda: MA.masked_attention_plain(qkv, mask, scale, h),
        lambda: MA.masked_attention_bwd_plain(qkv, mask, go, scale, h)), sdpa, card)
    bound_fwd, bound_bwd = _mqkv_bounds(b, s, d, h)
    out["mqkv_fwd"], out["mqkv_bwd"] = (fwd, bound_fwd), (bwd, bound_bwd)
    for name, (best, (bound_ms, by)) in out.items():
        ratios = ", ".join(f"{best['kernel'] / best[n]:.1f}x {n}" for n in best
                           if n.startswith("sdpa") and best[n] > 0)
        print(f"[bound] {name}: {bound_ms * 1e3:.1f} us, bound by {by}; kernel "
              f"{best['kernel'] / bound_ms:.1f}x the bound, {best['plain'] / best['kernel']:.2f}x "
              f"faster than plain, {ratios}")
    for other in (3, 4):  # the g-prompt and CODA prefix lengths
        (f_ms, f_by), (b_ms, b_by) = _pqkv_bounds(*P_TIMED[:2], other, *P_TIMED[3:])
        print(f"[bound] pqkv at P {other}: forward {f_ms * 1e3:.1f} us ({f_by}), "
              f"backward {b_ms * 1e3:.1f} us ({b_by})")
    return out


def _generic_bound(b, h, sq, skv, hd):
    """Bound of one bf16 generic forward: q, k, v read and o written once;
    two products over Sq x Skv."""
    return _bound(2 * b * h * hd * (2 * sq + 2 * skv), 4 * b * h * sq * skv * hd)


#: mmonly's yardstick: its function as two cuBLAS products in bf16 (the
#: scores rounded to bf16 from f32 sums, then times v); no one call computes it
MMONLY_YARDSTICK = "cublas (q @ k^T) @ v"


def _time_generic(label, shape, kernel, plain, card, library=True, others=None):
    """The kernel beside its plain version, (``library``) SDPA on the flash
    and cuDNN backends and ``others`` ({name: fn(q, k, v)}, yardsticks other
    than a library call), bf16, contiguous inputs; returns (best times,
    bound). The library time is the faster backend's."""
    b, h, sq, skv, hd = shape
    q, k, v = _generic_inputs(shape, torch.bfloat16, dev=torch.device("cuda", 0), seed=9,
                              strided=False)
    scale = hd ** -0.5
    sdpa = _sdpa_runs(q, k, v, None, scale, _flash_and_cudnn()) if library else {}
    best = _time_pair(f"{label} at B {b} H {h} Sq {sq} Skv {skv} hd {hd} bf16", {
        "plain": lambda: plain(q, k, v, scale), **{n: f for n, (f, _) in sdpa.items()},
        **{n: (lambda fn=fn: fn(q, k, v)) for n, fn in (others or {}).items()},
        "kernel": lambda: kernel(q, k, v, scale)}, card)
    _set_library(best, list(sdpa))
    bound = _generic_bound(*shape)
    ratios = ", ".join(f"{best['kernel'] / best[n]:.1f}x {n}" for n in [*sdpa, *(others or {})])
    print(f"[bound] {label}: {bound[0] * 1e3:.1f} us ({bound[1]}); kernel "
          f"{best['kernel'] / bound[0]:.1f}x the bound, {ratios or 'no SDPA call'}")
    return best, bound


def phase_generic_timing(dev, card):
    """``attn_fwd`` at the G_TIMED shapes, and each variant at the tool's
    (flash at exp_flash_kernel's S 197), beside plain, SDPA and the bound.
    Returns {kernels-line name: (best times, bound)}."""
    A = _attention_modules()[0]
    out = {}
    for i, (label, *shape) in enumerate(G_TIMED):
        res = _time_generic(f"attn_fwd {label}", tuple(shape), A.attention_cuda,
                            A.attention_plain, card)
        if i == 0:
            out["attn_fwd"] = res
        torch.cuda.empty_cache()
    for key, variant in G_VARIANT_OF.items():
        shape = G_FLASH if variant == "flash" else G_TOOL
        kernel = lambda q, k, v, scale, variant=variant: A.attention_variant_cuda(  # noqa: E731
            q, k, v, scale, variant)
        plain = lambda q, k, v, scale, variant=variant: A.attention_variant_plain(  # noqa: E731
            q, k, v, scale, variant)
        # mmonly computes no softmax: no library call computes its function,
        # two cuBLAS calls do
        mm = variant == "mmonly"
        two_calls = {MMONLY_YARDSTICK: lambda q, k, v: (q @ k.transpose(-1, -2)) @ v}
        out[key] = _time_generic(f"{key} ({variant})", shape, kernel, plain, card,
                                 library=not mm, others=two_calls if mm else None)
    return out


def phase_generic_tools(seen):
    """The port's two measurement tools at their defaults, on the card:
    ``bench_attention`` (B 128, H 12, S 217, D 64) and ``exp_flash_kernel``
    (S 197 and 222). Returns their launch counts; every CUDA candidate must
    run."""
    from libcontinual_tpu_torch.tools import bench_attention, exp_flash_kernel

    _reset_launches()
    with _recorded_shapes(seen):
        print("[tools] python -m libcontinual_tpu_torch.tools.bench_attention", flush=True)
        bench = bench_attention.main([])
        print("[tools] python -m libcontinual_tpu_torch.tools.exp_flash_kernel", flush=True)
        flash = exp_flash_kernel.main([])
    torch.cuda.synchronize()
    launches = _launches()
    print(f"[tools] kernel launches in the two tools: {launches}")
    failed = {n: r for n, r in bench.items() if not n.startswith("sdpa_") and "ms" not in r}
    _require(not failed, f"bench_attention candidates failed: {failed}")
    _require(all(r["err"] <= FLASH_F32_TOL for r in flash.values()),
             f"exp_flash_kernel: flash disagrees with the f32 forward: {flash}")
    return launches


def _conv_bounds(b, h, w, c, o):
    """(forward, weight-gradient) bounds of the conv kernels in bf16: x and
    the taps read and y written (bf16); x and g read and the f32 dw written;
    9 taps of a (B*H*W, C) x (C, O) product each."""
    act_x, act_y, flops = 2 * b * h * w * c, 2 * b * h * w * o, 2 * b * h * w * c * o * 9
    return (_bound(act_x + 2 * 9 * c * o + act_y, flops),
            _bound(act_x + act_y + 4 * 9 * c * o, flops))


def phase_conv_timing(dev, card):
    """The conv kernels at the stem and the four stages (bf16, B 128),
    beside their plain versions and cuDNN (``F.conv2d`` on ``channels_last``
    and its data and weight gradients through ``aten.convolution_backward``;
    the port never calls them): y, dx (the forward kernel on the output
    gradient and the rotated taps, bound by ``_conv_bounds`` with C and O
    swapped) and dw. Returns {shape: (fwd times, fwd bound, dw times, dw
    bound, dx times, dx bound)}."""
    C = _conv_module()
    out = {}
    for shape in C_MAIN:
        b, h, w, c, o = shape
        x, k, go = _conv_inputs(shape, torch.bfloat16, dev, seed=9)
        xc, gc = x.permute(0, 3, 1, 2), go.permute(0, 3, 1, 2)  # NCHW views of NHWC memory
        kc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        kr = C.rotate_taps(k).contiguous()
        tag = f"B {b} {h}x{w} C {c} -> O {o} bf16"
        fwd = _time_pair(f"conv3x3_fwd at {tag}", {
            "plain": lambda: C.conv3x3_plain(x, k),
            "library": lambda: F.conv2d(xc, kc, padding=1),
            "kernel": lambda: C.conv3x3_cuda(x, k)}, card, library="cudnn")
        dw = _time_pair(f"conv3x3_dw at {tag}", {
            "plain": lambda: C.conv3x3_dw_plain(x, go),
            "library": lambda: torch.ops.aten.convolution_backward(
                gc, xc, kc, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False]),
            "kernel": lambda: C.conv3x3_dw_cuda(x, go)}, card, library="cudnn")
        dx = _time_pair(f"conv3x3_fwd (dx) at {tag}", {
            "plain": lambda: C.conv3x3_plain(go, kr),
            "library": lambda: torch.ops.aten.convolution_backward(
                gc, xc, kc, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False]),
            "kernel": lambda: C.conv3x3_cuda(go, kr)}, card, library="cudnn")
        bound_fwd, bound_dw = _conv_bounds(*shape)
        bound_dx = _conv_bounds(b, h, w, o, c)[0]
        print(f"[bound] conv3x3 at {tag}: forward {bound_fwd[0] * 1e3:.1f} us ({bound_fwd[1]}), "
              f"dx {bound_dx[0] * 1e3:.1f} us ({bound_dx[1]}), "
              f"dw {bound_dw[0] * 1e3:.1f} us ({bound_dw[1]})")
        out[shape] = (fwd, bound_fwd, dw, bound_dw, dx, bound_dx)
        del x, k, go, xc, gc, kc, kr
    return out


def _step_setup(dev, name):
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.registry import METHODS

    if name in CLIP_CONFIGS:  # the shipped config as it is: batch 128, 224 px, 100 classes
        cfg = copy.deepcopy(CLIP_CONFIGS[name])
    else:
        cfg = copy.deepcopy(BENCH_CONFIG)
        cfg["classifier"] = {"name": name, "kwargs": {
            **METHOD_KWARGS[name], "num_class": 100, "feat_dim": 768,
            "init_cls_num": 10, "inc_cls_num": 10, "task_num": 10}}
    cfg = Config(overrides=cfg).get_config_dict()
    method = METHODS.get(name)(cfg, dev)
    state = method.init_state(1993, (32, 32, 3))
    rng = np.random.RandomState(0)
    bs = cfg["batch_size"]
    batch = {
        "image": torch.from_numpy(rng.randint(0, 255, (bs, 32, 32, 3)).astype(np.uint8)).to(dev),
        "label": torch.from_numpy(rng.randint(0, 10, (bs,))).to(dev),
        "weight": torch.ones(bs, device=dev),
    }
    return method, state, batch, bs


def phase_step_timing(dev, card, name, n_steps=20, profile=False):
    import libcontinual_tpu_torch.methods  # noqa: F401  (registers the methods)

    method, state, batch, bs = _step_setup(dev, name)

    def img_per_s():
        for _ in range(3):
            method.train_step(state, batch, 1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            method.train_step(state, batch, 1e-3)
        torch.cuda.synchronize()
        return n_steps * bs / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats(dev)
    kernel = img_per_s()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    with _plain_attention():
        plain = img_per_s()
    kernel2 = img_per_s()
    model = "CLIP ViT-B/16 + text tower" if name in CLIP_CONFIGS else "ViT-B/16"
    print(f"[timing] {name} train step, {model} bf16, batch {bs}, 32->224: "
          f"{kernel:.2f} and {kernel2:.2f} img/s with the kernels, {plain:.2f} img/s "
          f"with the plain attention; peak memory {peak:.2f} GiB [{card}]")
    if profile:
        _profile_step(method, state, batch, name, card)


def phase_icarl_step_timing(dev, card, n_steps=20):
    """The iCaRL / resnet18 train step at bench.py's protocol (batch 128,
    bf16, 32 px, the cifar transform stack) as in every task after the
    first: CE over 20 seen classes plus KD against a teacher."""
    import libcontinual_tpu_torch.methods  # noqa: F401  (registers the methods)
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.registry import METHODS

    cfg = Config(overrides=copy.deepcopy(ICARL_CONFIG)).get_config_dict()
    method = METHODS.get("ICarl")(cfg, dev)
    state = method.init_state(1993, (32, 32, 3))
    state = method.after_task(state, 0, None)  # the teacher
    state = method.start_task(state, 1, 10, 20)
    state = method.reset_optimizer(state, 1)
    rng = np.random.RandomState(0)
    bs = cfg["batch_size"]
    batch = {
        "image": torch.from_numpy(rng.randint(0, 255, (bs, 32, 32, 3)).astype(np.uint8)).to(dev),
        "label": torch.from_numpy(rng.randint(0, 20, (bs,))).to(dev),
        "weight": torch.ones(bs, device=dev),
    }

    def img_per_s():
        for _ in range(3):
            method.train_step(state, batch, 0.05)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            method.train_step(state, batch, 0.05)
        torch.cuda.synchronize()
        return n_steps * bs / (time.perf_counter() - t0)

    torch.cuda.reset_peak_memory_stats(dev)
    runs = [img_per_s(), img_per_s()]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[timing] iCaRL train step, resnet18 (CIFAR stem) bf16, batch {bs}, 32 px, KD on: "
          f"{runs[0]:.2f} and {runs[1]:.2f} img/s; peak memory {peak:.2f} GiB [{card}]")
    _profile_step(method, state, batch, "iCaRL", card, lr=0.05,
                  family=("cuDNN convolution (by name)",
                          ("fprop", "dgrad", "wgrad", "xmma", "cudnn", "implicit", "conv2d")))
    return runs


def phase_icarl_protocol(dev, card):
    """bench.py's end-to-end block in the port: the whole 10-task iCaRL run
    of ``ICARL_CONFIG`` through the trainer (60 images a class, 2 epochs a
    task, herding buffer 200), from building the trainer to its summary."""
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.core.trainer import Trainer

    cfg = Config(overrides=copy.deepcopy(ICARL_CONFIG)).get_config_dict()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    res = trainer.train_loop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = res["acc_table"]
    counts = np.bincount(trainer.buffer.labels, minlength=100)
    print(f"[protocol] 10-task iCaRL resnet18, 60 img/class synthetic CIFAR geometry, 2 "
          f"epochs/task, herding buffer 200: wall {wall:.2f} s, train_loop {res['time_sec']:.2f} s, "
          f"last avg acc {res['last_avg_acc']}, overall avg acc {res['batch_ovr_avg_acc']:.2f}, "
          f"inference {res['fps']:.0f} img/s [{card}]")
    print(f"[protocol] final acc row {table[-1].tolist()}")
    _require(table.shape == (10, 10) and np.isfinite(table).all(), "protocol: acc table not filled")
    _require(counts.tolist() == [2] * 100, "protocol: the buffer is not 2 exemplars a class")
    return wall, res


def _profile_step(method, state, batch, name, card, steps=3, lr=1e-3,
                  family=("attention", ("lct::attn_",))):
    """Device time per step by kernel, over ``steps`` steps after warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        method.train_step(state, batch, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            method.train_step(state, batch, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops repeat the time of the kernels they launch
        dev_us = _device_us(evt)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, evt.count / steps, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    label, keys = family
    part = sum(r[0] for r in rows if any(k in r[2] for k in keys))
    print(f"[profile] {name} step: {total:.3f} ms of kernel time a step ({part:.3f} ms in the "
          f"{label} kernels) in {wall_ms:.3f} ms of profiled wall time (kernels "
          f"{100 * total / wall_ms:.1f}% of it) [{card}]")
    for ms, calls, key in rows[:14]:
        print(f"[profile]   {ms:9.3f} ms  {calls:6.1f} calls  {key[:110]}")
    # the host's side: self CPU time of each op (under the profiler, which
    # adds its own cost to every op)
    host = sorted(((evt.self_cpu_time_total / 1e3 / steps, evt.count / steps, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == torch.autograd.DeviceType.CPU), reverse=True)
    print(f"[profile] {name} host: {sum(h[0] for h in host):.3f} ms of self CPU time a step in "
          f"{sum(h[1] for h in host):.0f} op calls; {sum(r[1] for r in rows):.0f} device "
          f"kernels a step [{card}]")
    for ms, calls, key in host[:8]:
        print(f"[profile]   host {ms:9.3f} ms  {calls:6.1f} calls  {key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)} [{card}]")
    t_start = time.perf_counter()

    phase_build()
    errs = dict.fromkeys(SOURCE_LINES, 0.0)
    checked, seen = set(), set()
    phase_checks(dev, errs, checked)
    phase_prefix_checks(dev, errs, checked)
    phase_masked_checks(dev, errs, checked)
    phase_bwd_determinism(dev)
    phase_fwd_determinism(dev)
    phase_conv_checks(dev, errs, checked)
    t_gen = time.perf_counter()
    phase_generic_checks(dev, errs, checked)
    t_generic = time.perf_counter() - t_gen

    launches, captures = {}, {}
    for name in ("L2P", "DualPrompt", "CodaPrompt", "DAP", "MoE_Adapter4CL", "RAPF"):
        trainer, launches[name], _, _ = phase_slice(dev, name, seen)
        if name in ("L2P", "DAP"):
            phase_slice_reference(trainer, dev, name)
        elif name == "DualPrompt":
            phase_prefix_slice_reference(trainer, dev)
        elif name == "MoE_Adapter4CL":
            phase_clip_reference(trainer, dev)
        if name in ("L2P", "DualPrompt"):
            t_gen = time.perf_counter()
            captures[name] = capture_generic_path(trainer, dev, name, seen)
            t_generic += time.perf_counter() - t_gen
        del trainer
        torch.cuda.empty_cache()
    trainer = phase_icarl_slice(dev)
    launches["iCaRL_resnet18 conv3x3"] = phase_icarl_conv_path(trainer, dev, seen)
    del trainer
    torch.cuda.empty_cache()
    t_gen = time.perf_counter()
    launches[GENERIC_PATH] = phase_generic_path(captures, dev, seen)
    del captures
    torch.cuda.empty_cache()
    launches[TOOLS_PATH] = phase_generic_tools(seen)
    t_generic += time.perf_counter() - t_gen
    # every shape the slices gave a kernel was checked against the plain version
    print(f"[slices] kernel shapes launched (kernel, S, [P,] D, heads, dtype; or kernel, H, W, "
          f"C, O, dtype): {sorted(map(str, seen))}")
    _require(not seen - checked, f"kernels launched at unchecked shapes: {seen - checked}")

    times = phase_kernel_timing(dev, card)
    conv_times = phase_conv_timing(dev, card)
    fwd, bound_fwd, dw, bound_dw, dx, bound_dx = conv_times[C_TIMED]
    times["conv3x3_fwd"], times["conv3x3_dw"] = (fwd, bound_fwd), (dw, bound_dw)
    t_gen = time.perf_counter()
    times.update(phase_generic_timing(dev, card))
    t_generic += time.perf_counter() - t_gen
    print(f"[env] the generic attention phases (checks, capture, path, tools, timing) in "
          f"{t_generic:.1f} s")
    phase_step_timing(dev, card, "L2P", profile=True)
    phase_step_timing(dev, card, "DualPrompt", profile=True)
    phase_step_timing(dev, card, "MoE_Adapter4CL", profile=True)
    phase_icarl_step_timing(dev, card)
    phase_icarl_protocol(dev, card)
    print(f"[env] all phases in {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for kname, line in SOURCE_LINES.items():
        best, (bound_ms, by) = times[kname]
        # the main path of each kernel: MoE-Adapter4CL runs the qkv and masked
        # kernels, DualPrompt the prefix kernels, the trained iCaRL
        # resnet18's convolutions the conv kernels, the captured L2P and
        # DualPrompt blocks the generic kernel, and the two tools its variants
        path = ("DualPrompt" if kname.startswith("pqkv") else
                "iCaRL_resnet18 conv3x3" if kname.startswith("conv") else
                GENERIC_PATH if kname == "attn_fwd" else
                TOOLS_PATH if kname.startswith("attn_fwd_") else "MoE_Adapter4CL")
        entry = {
            "name": kname, "route": "cuda", "source": SOURCES[kname], "replaces": line,
            "launches": launches[path][kname], "main_path": path,
            "launches_by_path": {p: n[kname] for p, n in launches.items()},
            "max_abs_err": errs[kname], "ms": best["kernel"], "plain_ms": best["plain"],
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": by,
            "library_ms": best["library"],
        }
        if kname.endswith("qkv_bwd"):
            entry["dq_ms"], entry["dkdv_ms"] = best["dq"], best["dkdv"]
        if kname == "attn_fwd_mmonly":
            entry["yardstick"], entry["yardstick_ms"] = MMONLY_YARDSTICK, best[MMONLY_YARDSTICK]
        if kname.startswith("conv"):
            b, h, w, c, o = C_TIMED
            entry["library"] = "cuDNN"
            entry["shape"] = f"B {b} {h}x{w} C {c} -> O {o} bf16"
            if kname == "conv3x3_fwd":  # dx: the same kernel at C_TIMED with C and O swapped
                entry["dx_ms"], entry["dx_plain_ms"] = dx["kernel"], dx["plain"]
                entry["dx_library_ms"], entry["dx_bound_ms"] = dx["library"], bound_dx[0]
        else:
            entry["library"] = best["library_name"] and f"SDPA ({best['library_name']})"
        if kname.startswith("attn"):
            b, h, sq, skv, hd = (G_TIMED[0][1:] if kname == "attn_fwd" else
                                 G_FLASH if kname == "attn_fwd_flash" else G_TOOL)
            entry["shape"] = f"B {b} H {h} Sq {sq} Skv {skv} hd {hd} bf16"
        elif kname.startswith("qkv"):
            entry["shape"] = "B {} S {} D {} H {} bf16".format(*TIMED)
        elif kname.startswith("pqkv"):
            entry["shape"] = "B {} S {} P {} D {} H {} bf16".format(*P_TIMED)
        elif kname.startswith("mqkv"):
            entry["shape"] = "B {} S {} D {} H {} bf16 causal".format(*M_TIMED)
        kernels.append(entry)
    for k in kernels:
        _require(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
