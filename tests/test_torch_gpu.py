"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions. They need a CUDA device and ``nvcc``, and skip elsewhere. Run them
on the card with ``python -m pytest tests/test_torch_gpu.py -m gpu
--noconftest`` (``tests/conftest.py`` imports jax, which the card's machine
may not have).
``chip_smoke.py`` makes the same comparisons at the main path's shapes."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from libcontinual_tpu_torch.ops import attention as T
from libcontinual_tpu_torch.ops import layer_norm as LN
from libcontinual_tpu_torch.ops import masked_attention as MT
from libcontinual_tpu_torch.ops import prefix_attention as PT

pytestmark = pytest.mark.gpu

#: bf16: identical rounding points, f32 sums in another order; two bf16 ulps
#: at the largest output magnitude. f32: summation order only.
TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


# (B, S, H, hd). Every S here is a key count that is no multiple of the
# 64-key tile; S 300 is past the 256 keys of the port's first kernels, hd 48
# and 128 past their 16/32/64 head dims, hd 20 (40 bytes a row) takes the
# element-wise staging instead of the 16-byte copies
LONG_SHAPES = [(1, 300, 2, 128), (2, 260, 3, 48), (2, 33, 3, 20)]
# the edges of the tensor-core kernels' tiles at hd 64: a warp's 16 rows and
# a block's 64 (S 16, 64, 65, 128)
EDGE_SHAPES = [(2, 16, 2, 64), (2, 64, 2, 64), (2, 65, 2, 64), (2, 128, 2, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 4, 16), (3, 70, 2, 32), (2, 197, 12, 64),
                                   *LONG_SHAPES, *EDGE_SHAPES])
def test_kernels_match_plain(cuda, dtype, shape):
    b, s, h, hd = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, s, 3 * h * hd, device=cuda, generator=g).to(dtype)
    go = torch.randn(b, s, h * hd, device=cuda, generator=g).to(dtype)
    scale = hd ** -0.5
    out = T.qkv_attention_cuda(qkv, scale, h)
    dqkv = T.qkv_attention_bwd_cuda(qkv, go, scale, h)
    torch.cuda.synchronize()
    assert _err(out, T.qkv_attention_plain(qkv, scale, h)) <= TOL[dtype]
    assert _err(dqkv, T.qkv_attention_bwd_plain(qkv, go, scale, h)) <= TOL[dtype]


def test_autograd_function_launches_both_kernels(cuda):
    qkv = torch.randn(2, 9, 3 * 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    T.reset_launches()
    T.fused_qkv_attention(qkv, 0.25, 4).float().sum().backward()
    assert T.LAUNCHES == {**dict.fromkeys(T.LAUNCHES, 0), "qkv_fwd": 1, "qkv_bwd": 1,
                          "qkv_fwd_onepass": 1, "qkv_bwd_onepass": 1}


def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    # S 300 runs (no key ceiling) and matches the plain version
    qkv = torch.randn(1, 300, 192, device=cuda)
    out = T.qkv_attention_cuda(qkv, 0.25, 4)
    assert _err(out, T.qkv_attention_plain(qkv, 0.25, 4)) <= TOL[torch.float32]
    # (B, S, 3D) with D 64: 3 heads do not divide it; D 160 in one head is past hd 128
    with pytest.raises(ValueError, match="head dim"):
        T.qkv_attention_cuda(torch.zeros(1, 8, 192, device=cuda), 0.25, 3)
    with pytest.raises(ValueError, match="head dim 160/1"):
        T.qkv_attention_cuda(torch.zeros(1, 8, 480, device=cuda), 0.25, 1)
    with pytest.raises(ValueError, match="grid"):
        T.qkv_attention_cuda(torch.zeros(65536, 1, 48, device=cuda), 0.25, 1)
    with pytest.raises(TypeError):
        T.qkv_attention_cuda(torch.zeros(1, 8, 192, device=cuda, dtype=torch.float16), 0.25, 4)
    with pytest.raises(ValueError, match="contiguous"):
        T.qkv_attention_cuda(torch.zeros(1, 192, 8, device=cuda).transpose(1, 2), 0.25, 4)


def _prefix_inputs(cuda, shape, dtype, layout):
    b, s, p, h, hd = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(b, s, 3 * h * hd, device=cuda, generator=g).to(dtype)
    go = torch.randn(b, s, h * hd, device=cuda, generator=g).to(dtype)
    rows = b if layout == "image" else 1
    pk, pv = (torch.randn(rows, p, h * hd, device=cuda, generator=g).to(dtype).expand(b, -1, -1)
              for _ in range(2))
    return qkv, pk, pv, go


@pytest.mark.parametrize("layout", ["image", "broadcast"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 3, 4, 16), (3, 70, 1, 2, 32), (2, 197, 10, 12, 64),
                                   (1, 59, 5, 2, 64),  # (B, S, P, H, hd); 59 + 5 = one key tile
                                   # 257 keys at hd 128; P 70 past the first key tile, so
                                   # the second tile straddles P; hd 48; hd 20
                                   (2, 250, 7, 2, 128), (2, 230, 70, 2, 64),
                                   (2, 260, 4, 3, 48), (2, 33, 3, 3, 20),
                                   # the tile edges: P + S = 64, 65, 128 and 130 keys
                                   (2, 16, 48, 2, 64), (2, 64, 1, 2, 64), (2, 65, 63, 2, 64),
                                   (2, 128, 2, 2, 64)])
def test_prefix_kernels_match_plain(cuda, dtype, shape, layout):
    hd = shape[-1]
    qkv, pk, pv, go = _prefix_inputs(cuda, shape, dtype, layout)
    scale = hd ** -0.5
    out = PT.prefix_attention_cuda(qkv, pk, pv, scale, shape[3])
    grads = PT.prefix_attention_bwd_cuda(qkv, pk, pv, go, scale, shape[3])
    torch.cuda.synchronize()
    assert _err(out, PT.prefix_attention_plain(qkv, pk, pv, scale, shape[3])) <= TOL[dtype]
    ref = PT.prefix_attention_bwd_plain(qkv, pk, pv, go, scale, shape[3])
    for a, r in zip(grads, ref):
        assert a.shape == r.shape and _err(a, r) <= TOL[dtype]


def test_prefix_autograd_function_launches_both_kernels(cuda):
    """Also when qkv needs no gradient (a ViT's first block, whose input
    holds no prompt): the backward still runs and writes the prompt's."""
    qkv = torch.randn(2, 9, 3 * 64, device=cuda, dtype=torch.bfloat16)
    pk = torch.randn(2, 3, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    pv = torch.randn(2, 3, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    T.reset_launches()
    PT.fused_prefix_attention(qkv, pk, pv, 0.25, 4).float().sum().backward()
    assert T.LAUNCHES == {**dict.fromkeys(T.LAUNCHES, 0), "pqkv_fwd": 1, "pqkv_bwd": 1,
                          "pqkv_fwd_onepass": 1, "pqkv_bwd_onepass": 1}
    assert pk.grad is not None and pv.grad is not None and pv.grad.abs().sum() > 0


def test_prefix_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    # S + P = 257 keys runs (no key ceiling) and matches the plain version
    qkv = torch.randn(1, 250, 192, device=cuda)
    pk, pv = torch.randn(1, 7, 64, device=cuda), torch.randn(1, 7, 64, device=cuda)
    out = PT.prefix_attention_cuda(qkv, pk, pv, 0.25, 4)
    assert _err(out, PT.prefix_attention_plain(qkv, pk, pv, 0.25, 4)) <= TOL[torch.float32]
    pk = torch.zeros(1, 6, 64, device=cuda)
    with pytest.raises(ValueError, match="same"):
        PT.prefix_attention_cuda(qkv[:, :8], pk, pk[:, :2], 0.25, 4)
    with pytest.raises(ValueError, match="does not match"):
        PT.prefix_attention_cuda(qkv[:, :8], pk.bfloat16(), pk.bfloat16(), 0.25, 4)
    with pytest.raises(ValueError, match="head dim"):
        PT.prefix_attention_cuda(qkv[:, :8], pk, pk, 0.25, 3)
    wide = torch.zeros(1, 6, 160, device=cuda)  # one head of 160
    with pytest.raises(ValueError, match="head dim 160/1"):
        PT.prefix_attention_cuda(torch.zeros(1, 8, 480, device=cuda), wide, wide, 0.25, 1)


def _masked_inputs(cuda, shape, dtype, kind):
    b, s, h, hd = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(b, s, 3 * h * hd, device=cuda, generator=g).to(dtype)
    go = torch.randn(b, s, h * hd, device=cuda, generator=g).to(dtype)
    if kind == "causal":
        mask = torch.triu(torch.full((s, s), -1e30, device=cuda), diagonal=1)
    else:  # a general finite mask
        mask = 3.0 * torch.randn(s, s, device=cuda, generator=g)
    return qkv, mask, go


@pytest.mark.parametrize("kind", ["causal", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 17, 4, 16), (3, 77, 8, 64), (2, 70, 2, 32),
                                   *LONG_SHAPES, *EDGE_SHAPES])
def test_masked_kernels_match_plain(cuda, dtype, shape, kind):
    qkv, mask, go = _masked_inputs(cuda, shape, dtype, kind)
    h, hd = shape[2], shape[3]
    scale = hd ** -0.5
    out = MT.masked_attention_cuda(qkv, mask, scale, h)
    dqkv = MT.masked_attention_bwd_cuda(qkv, mask, go, scale, h)
    torch.cuda.synchronize()
    assert _err(out, MT.masked_attention_plain(qkv, mask, scale, h)) <= TOL[dtype]
    assert _err(dqkv, MT.masked_attention_bwd_plain(qkv, mask, go, scale, h)) <= TOL[dtype]


@pytest.mark.parametrize("s", [150, 222, 300])
@pytest.mark.parametrize("family", ["qkv", "prefix", "masked"])
def test_backward_is_deterministic(cuda, family, s):
    """Two calls on the same inputs give the same bits: no atomics, every
    sum in a fixed order (bf16, several query and key tiles; S 150 and 222
    on the one-pass kernel, S 300 on the streaming pair)."""
    qkv, mask, go = _masked_inputs(cuda, (3, s, 4, 64), torch.bfloat16, "random")
    _, pk, pv, _ = _prefix_inputs(cuda, (3, s, 10, 4, 64), torch.bfloat16, "image")

    def call():
        if family == "qkv":
            return [T.qkv_attention_bwd_cuda(qkv, go, 0.125, 4)]
        if family == "prefix":
            return list(PT.prefix_attention_bwd_cuda(qkv, pk, pv, go, 0.125, 4))
        return [MT.masked_attention_bwd_cuda(qkv, mask, go, 0.125, 4)]

    first, second = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


#: (family, shape) of the one-pass forward's checks: qkv (B, S, H, hd), prefix
#: (B, S, P, H, hd), masked (B, S, H, hd, mask). Keys N = P + S: 1, a warp's
#: and a block's edges, the ViT's 197 and 222, 256 (the most it takes) and 257
#: (the streaming kernel's); hd 20 (element copies) and 48; a prefix whose
#: first 64-key block straddles P; the text tower's causal S 77
ONEPASS_CASES = [
    *[("qkv", (2, n, 2, 64)) for n in (1, 63, 64, 65, 128, 256, 257)],
    ("qkv", (2, 197, 4, 64)), ("qkv", (2, 222, 4, 64)), ("qkv", (2, 150, 3, 20)),
    ("qkv", (2, 150, 3, 48)),
    ("prefix", (2, 197, 10, 4, 64)), ("prefix", (2, 40, 30, 3, 20)), ("prefix", (2, 250, 7, 2, 64)),
    ("masked", (3, 77, 8, 64, "causal")), ("masked", (2, 100, 3, 48, "random")),
    ("masked", (2, 257, 2, 64, "causal")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ONEPASS_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_onepass_forward_engages_where_it_should_and_matches_plain(cuda, dtype, case):
    """The forward against its plain version; the one-pass kernel takes it
    exactly at bf16, hd <= 64 and N <= 256 (its counter and the C side's
    predicate say so), the streaming kernel elsewhere; two calls give the
    same bits."""
    family, shape = case
    p = 0
    if family == "prefix":
        b, s, p, h, hd = shape
        qkv, pk, pv, _ = _prefix_inputs(cuda, shape, dtype, "image")
        key, args = "pqkv_fwd", (qkv, pk, pv)
        kernel, plain = PT.prefix_attention_cuda, PT.prefix_attention_plain
    elif family == "masked":
        b, s, h, hd, kind = shape
        qkv, mask, _ = _masked_inputs(cuda, (b, s, h, hd), dtype, kind)
        key, args = "mqkv_fwd", (qkv, mask)
        kernel, plain = MT.masked_attention_cuda, MT.masked_attention_plain
    else:
        b, s, h, hd = shape
        g = torch.Generator(device=cuda).manual_seed(3)
        qkv = torch.randn(b, s, 3 * h * hd, device=cuda, generator=g).to(dtype)
        key, args = "qkv_fwd", (qkv,)
        kernel, plain = T.qkv_attention_cuda, T.qkv_attention_plain
    engages = dtype == torch.bfloat16 and hd <= 64 and p + s <= 256
    assert T.onepass(p + s, hd, dtype) == engages
    T.reset_launches()
    first, second = kernel(*args, hd ** -0.5, h), kernel(*args, hd ** -0.5, h)
    torch.cuda.synchronize()
    assert T.LAUNCHES == {**dict.fromkeys(T.LAUNCHES, 0), key: 2, key + "_onepass": 2 * engages}
    assert _err(first, plain(*args, hd ** -0.5, h)) <= TOL[dtype]
    assert torch.equal(first, second)


#: (family, shape) of the one-pass backward's checks, as ONEPASS_CASES: keys
#: N = P + S of 1, 63, 64, 65, 128, 129, 192, 255, 256 (the most it takes) and
#: 257 and 300 (the streaming pair's); the ViT's 197 and 222 at odd B; prefixes
#: of 5 and 10 rows (DualPrompt's 197 + 10), one whose first 64-key block
#: straddles P and one past a whole block; the text tower's causal S 77; hd 20 (element copies), 48 and
#: 128 (the streaming pair's)
ONEPASS_BWD_CASES = [
    *[("qkv", (2, n, 2, 64)) for n in (1, 63, 64, 65, 128, 129, 192, 255, 256, 257, 300)],
    ("qkv", (3, 197, 4, 64)), ("qkv", (3, 222, 4, 64)), ("qkv", (2, 150, 3, 20)),
    ("qkv", (2, 150, 3, 48)), ("qkv", (2, 200, 2, 128)),
    ("prefix", (3, 197, 10, 4, 64)), ("prefix", (3, 217, 5, 4, 64)),
    ("prefix", (2, 40, 30, 3, 20)), ("prefix", (2, 60, 70, 2, 64)), ("prefix", (2, 250, 6, 2, 64)),
    ("prefix", (2, 250, 7, 2, 64)),
    ("masked", (3, 77, 8, 64, "causal")), ("masked", (2, 100, 3, 48, "random")),
    ("masked", (2, 256, 2, 64, "causal")), ("masked", (2, 257, 2, 64, "causal")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ONEPASS_BWD_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_onepass_backward_engages_where_it_should_and_matches_plain(cuda, dtype, case):
    """The backward against its plain version, at the streaming pair's
    tolerance; the one-pass kernel takes it exactly at bf16, hd <= 64 and
    N <= 256 (its counter and the C side's one predicate, the forward's, say
    so), the streaming pair elsewhere; two calls give the same bits."""
    family, shape = case
    p = 0
    if family == "prefix":
        b, s, p, h, hd = shape
        qkv, pk, pv, go = _prefix_inputs(cuda, shape, dtype, "image")
        key, args = "pqkv_bwd", (qkv, pk, pv, go)
        kernel, plain = PT.prefix_attention_bwd_cuda, PT.prefix_attention_bwd_plain
    elif family == "masked":
        b, s, h, hd, kind = shape
        qkv, mask, go = _masked_inputs(cuda, (b, s, h, hd), dtype, kind)
        key, args = "mqkv_bwd", (qkv, mask, go)
        kernel, plain = MT.masked_attention_bwd_cuda, MT.masked_attention_bwd_plain
    else:
        b, s, h, hd = shape
        g = torch.Generator(device=cuda).manual_seed(4)
        qkv = torch.randn(b, s, 3 * h * hd, device=cuda, generator=g).to(dtype)
        go = torch.randn(b, s, h * hd, device=cuda, generator=g).to(dtype)
        key, args = "qkv_bwd", (qkv, go)
        kernel, plain = T.qkv_attention_bwd_cuda, T.qkv_attention_bwd_plain
    engages = dtype == torch.bfloat16 and hd <= 64 and p + s <= 256
    assert T.onepass(p + s, hd, dtype) == engages
    T.reset_launches()
    first, second = kernel(*args, hd ** -0.5, h), kernel(*args, hd ** -0.5, h)
    torch.cuda.synchronize()
    assert T.LAUNCHES == {**dict.fromkeys(T.LAUNCHES, 0), key: 2, key + "_onepass": 2 * engages}
    first, second = (x if isinstance(x, tuple) else (x,) for x in (first, second))
    ref = plain(*args, hd ** -0.5, h)
    for a, r in zip(first, ref if isinstance(ref, tuple) else (ref,)):
        assert a.shape == r.shape and _err(a, r) <= TOL[dtype]
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_masked_wrappers_refuse_a_wrong_mask(cuda):
    qkv = torch.zeros(1, 8, 192, device=cuda)
    with pytest.raises(ValueError, match="mask"):
        MT.masked_attention_cuda(qkv, torch.zeros(8, 7, device=cuda), 0.25, 4)
    with pytest.raises(ValueError, match="mask"):
        MT.masked_attention_cuda(qkv, torch.zeros(8, 8), 0.25, 4)  # on the host
    with pytest.raises(TypeError, match="mask dtype"):
        MT.masked_attention_cuda(qkv, torch.zeros(8, 8, device=cuda, dtype=torch.bfloat16),
                                 0.25, 4)
    with pytest.raises(ValueError, match="mask"):
        MT.masked_attention_bwd_cuda(qkv, torch.zeros(1, 8, 8, device=cuda),
                                     torch.zeros(1, 8, 64, device=cuda), 0.25, 4)


def test_moe_adapter_step_launches_the_masked_backward_per_text_block(cuda):
    """One MoE-Adapter4CL step on ``clip_tiny_test``: the text tower's
    blocks 1.. need the masked backward; block 0's qkv depends on frozen
    weights only, so it needs none."""
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.methods.clip_methods import MoEAdapter4CL

    cfg = Config(overrides={
        "dataset": "synthetic", "data_root": "", "image_size": 32, "task_num": 2,
        "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 8, "dtype": "bfloat16",
        "backbone": {"name": "clip_tiny_test", "kwargs": {"moe_experts": 2, "moe_text_gate": "eot"}},
        "classifier": {"name": "MOE_ADAPTER4CL", "kwargs": {"num_class": 8, "feat_dim": 32}},
        "optimizer": {"name": "Adam", "kwargs": {"lr": 1e-3}},
    }).get_config_dict()
    method = MoEAdapter4CL(cfg, cuda)
    state = method.init_state(0, (32, 32, 3))
    batch = {"image": torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 4, (8,), device=cuda), "weight": torch.ones(8, device=cuda)}
    T.reset_launches()
    method.train_step(state, batch, 1e-3)
    torch.cuda.synchronize()
    depth = len(state.params["clip"].text.blocks)
    # bf16, hd 16, 77 keys: every forward and backward takes the one-pass kernel
    masked = {k: n for k, n in T.LAUNCHES.items() if k.startswith("mqkv")}
    assert masked == {"mqkv_fwd": depth, "mqkv_bwd": depth - 1, "mqkv_fwd_onepass": depth,
                      "mqkv_bwd_onepass": depth - 1}


class _PlainQKV(torch.autograd.Function):
    """The packed attention's plain forward and backward as one autograd
    function: the reference of a whole-step comparison."""

    @staticmethod
    def forward(ctx, qkv, scale, heads):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.heads = scale, heads
        return T.qkv_attention_plain(qkv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return T.qkv_attention_bwd_plain(qkv, g.contiguous(), ctx.scale, ctx.heads), None, None


#: a whole DMNSP step in bf16, kernels against the plain attention: relative
#: L2 error of the loss and of each adapter gradient (``chip_smoke.py``'s
#: whole-batch tolerance)
STEP_TOL = 5e-2


def test_dmnsp_step_kernels_match_plain_attention(cuda, monkeypatch):
    """One DMNSP batch at task 1 with the projection on, on a bf16
    ``vit_tiny_test`` with 8-wide adapters: the loss and the projected
    adapter gradients through the packed kernels agree with the plain
    attention's; the step launches the forward in every block and the
    backward in all but block 0 (whose attention input depends on frozen
    weights only)."""
    import numpy as np

    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.data.continual import TaskData
    from libcontinual_tpu_torch.methods.dmnsp import DMNSP
    from libcontinual_tpu_torch.models import vit

    norm = [{"Normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]}}]
    cfg = Config(overrides={
        "dataset": "synthetic", "data_root": "", "image_size": 32, "task_num": 2,
        "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 16, "dtype": "bfloat16",
        "train_trfms": norm, "test_trfms": norm,
        "backbone": {"name": "vit_tiny_test", "kwargs": {"adapter_dim": 8}},
        "classifier": {"name": "DMNSP", "kwargs": {"num_class": 8, "feat_dim": 64,
                                                   "embd_dim": 64}},
        "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05}},
    }).get_config_dict()
    method = DMNSP(cfg, cuda)
    state = method.init_state(0, (32, 32, 3))
    rng = np.random.RandomState(0)
    tasks = [TaskData(rng.randint(0, 256, (32, 32, 32, 3)).astype(np.uint8),
                      np.repeat(np.arange(lo, lo + 4), 8).astype(np.int32), lo, lo + 4)
             for lo in (0, 4)]
    batches = [{"image": torch.from_numpy(td.images[::2]).to(cuda),
                "label": torch.from_numpy(td.labels[::2].astype(np.int64)).to(cuda),
                "weight": torch.ones(16, device=cuda)} for td in tasks]
    state, _ = method.train_step(state, batches[0], 0.05)  # up leaves zero: down gets gradients
    state = method.after_task(state, 0, tasks[0])
    state = method.before_task(method.start_task(state, 1, 4, 8), 1, tasks[1])
    assert state.mvars["proj_on"]
    batch = batches[1]
    draws = method.draw(state, batch)
    method.draw = lambda s, b: draws

    def loss_and_grads():
        state.params.zero_grad(set_to_none=True)
        x = method.augment(None, batch["image"], train=False)
        loss, _ = method.loss(state, dict(batch, x=x))
        loss.backward()
        method.transform_grads(state)
        return loss.detach(), {k: p.grad.clone() for k, p in
                               state.params["adapters"].named_parameters()}

    T.reset_launches()
    got = loss_and_grads()
    torch.cuda.synchronize()
    depth = len(state.mvars["frozen"].blocks)
    assert (T.LAUNCHES["qkv_fwd"], T.LAUNCHES["qkv_bwd"]) == (depth, depth - 1)
    monkeypatch.setattr(vit, "fused_qkv_attention", _PlainQKV.apply)
    T.reset_launches()
    ref = loss_and_grads()
    assert not any(T.LAUNCHES.values())
    assert float((got[0] - ref[0]).abs()) <= STEP_TOL * float(ref[0].abs())
    for k, g in ref[1].items():
        assert float(g.norm()) > 0, k
        assert float((got[1][k] - g).norm()) <= STEP_TOL * float(g.norm()), k


#: the conv kernels: bf16 inputs and f32 sums in both, a different sum order;
#: relative to the largest magnitude, as above (dw is f32 in both)
CONV_SHAPES = [(3, 5, 7, 3, 8), (2, 9, 6, 20, 24), (2, 4, 4, 20, 24), (5, 3, 3, 7, 70),
               (2, 3, 80, 16, 16), (4, 8, 8, 64, 64), (1, 2, 9, 5, 6),
               (1, 70, 70, 8, 8),  # (B, H, W, C, O); the last two outside the TPU gate
               # the weight gradient's tile edges: C and O of 16, 17 and 65, rows
               # of no whole 16-byte chunks (C 5), images smaller than a 16-pixel
               # mma tile (3 x 3, 1 x 1), a 128-pixel step spanning nine images
               (2, 5, 7, 16, 17), (1, 3, 4, 17, 65), (1, 4, 3, 65, 16), (3, 3, 3, 5, 17),
               (40, 1, 1, 8, 8), (9, 4, 4, 32, 72),
               # the bf16 forward's tile edges: M of 127, 128 and 129 pixels
               # around its 128-pixel tile, a row wider than a tile,
               # a tile spanning several images, the stem's dx (64 -> 3) at a
               # small batch, C and O of 3, 8, 16, 17 and 65, and enough
               # pixel tiles (O 520) for the 256-pixel blocks, also with rows
               # of no whole 16-byte chunks (C 5)
               (1, 1, 127, 16, 24), (2, 8, 8, 24, 16), (1, 3, 43, 17, 8), (1, 3, 200, 16, 16),
               (3, 8, 8, 64, 64), (4, 32, 32, 64, 3), (2, 5, 6, 3, 65), (2, 6, 5, 65, 3),
               (1, 9, 9, 8, 17), (2, 7, 3, 17, 8), (1, 65, 65, 8, 520), (1, 61, 61, 5, 520)]


def _conv_inputs(cuda, shape, dtype):
    b, h, w, c, o = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(b, h, w, c, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, c, o, device=cuda, generator=g) * (2.0 / (9 * c)) ** 0.5).to(dtype)
    go = torch.randn(b, h, w, o, device=cuda, generator=g).to(dtype)
    return x, k, go


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernels_match_plain(cuda, dtype, shape):
    from libcontinual_tpu_torch.ops import conv as C

    x, k, go = _conv_inputs(cuda, shape, dtype)
    y = C.conv3x3_cuda(x, k)
    dx = C.conv3x3_cuda(go, C.rotate_taps(k).contiguous())
    dw = C.conv3x3_dw_cuda(x, go)
    torch.cuda.synchronize()
    assert _err(y, C.conv3x3_plain(x, k)) <= TOL[dtype]
    assert _err(dx, C.conv3x3_plain(go, C.rotate_taps(k))) <= TOL[dtype]
    assert dw.dtype == torch.float32 and _err(dw, C.conv3x3_dw_plain(x, go)) <= TOL[torch.float32]


@pytest.mark.parametrize("shape", [(16, 32, 32, 64, 64), (16, 4, 4, 512, 512)])
def test_conv_dw_is_deterministic(cuda, shape):
    """The bf16 weight gradient twice on the same inputs at a main-path
    shape (resnet18's first and last stage at B 16): bitwise-equal results
    (a fixed-order reduce over the slices, no atomics)."""
    from libcontinual_tpu_torch.ops import conv as C

    x, _, go = _conv_inputs(cuda, shape, torch.bfloat16)
    first, second = C.conv3x3_dw_cuda(x, go), C.conv3x3_dw_cuda(x, go)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("shape", [(16, 32, 32, 64, 64), (16, 8, 8, 256, 256)])
def test_conv_fwd_is_deterministic(cuda, shape):
    """The bf16 forward twice on the same inputs at a main-path shape
    (resnet18's first and third stage at B 16), for y and for dx on the
    rotated taps: bitwise-equal results (one fixed sum order, no atomics)."""
    from libcontinual_tpu_torch.ops import conv as C

    x, k, go = _conv_inputs(cuda, shape, torch.bfloat16)
    kr = C.rotate_taps(k).contiguous()
    for inp, taps in ((x, k), (go, kr)):
        first, second = C.conv3x3_cuda(inp, taps), C.conv3x3_cuda(inp, taps)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_conv_autograd_launches_both_kernels(cuda):
    """The backward is one forward-kernel launch (dx) and one dw launch, on
    any image size: those the JAX package sends to XLA (H 2, H * W > 4096)
    launch the kernels too, and match the plain versions."""
    from libcontinual_tpu_torch.ops import conv as C

    for shape in [(2, 8, 8, 16, 24), (2, 2, 8, 16, 24), (1, 65, 65, 4, 8)]:
        x, k, go = _conv_inputs(cuda, shape, torch.float32)
        xg, kg = x.clone().requires_grad_(), k.clone().requires_grad_()
        C.reset_launches()
        C.conv3x3(xg, kg).backward(go)
        torch.cuda.synchronize()
        assert C.LAUNCHES == {"conv3x3_fwd": 2, "conv3x3_dw": 1}
        assert _err(xg.grad, C.conv3x3_plain(go, C.rotate_taps(k))) <= TOL[torch.float32]
        assert _err(kg.grad, C.conv3x3_dw_plain(x, go).reshape(k.shape)) <= TOL[torch.float32]


def test_conv_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    from libcontinual_tpu_torch.ops import conv as C

    w = torch.zeros(3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="empty"):
        C.conv3x3_cuda(torch.zeros(0, 8, 8, 4, device=cuda), w)
    with pytest.raises(ValueError, match="empty"):
        C.conv3x3_dw_cuda(torch.zeros(1, 0, 8, 4, device=cuda), torch.zeros(1, 0, 8, 8, device=cuda))
    with pytest.raises(TypeError):
        C.conv3x3_cuda(torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16), w.half())
    with pytest.raises(ValueError, match="does not match"):
        C.conv3x3_cuda(torch.zeros(1, 8, 8, 4, device=cuda), w.bfloat16())


def test_icarl_train_step_on_the_card(cuda):
    """One iCaRL step of the second task (CE and KD against the teacher) on a
    bf16 resnet18 at CIFAR geometry: a finite loss, the weights and the
    running statistics move, the teacher's statistics do not."""
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.methods.icarl import ICarl

    cfg = Config(overrides={
        "dataset": "synthetic", "data_root": "", "image_size": 32, "task_num": 2,
        "init_cls_num": 4, "inc_cls_num": 4, "batch_size": 8, "dtype": "bfloat16",
        "backbone": {"name": "resnet18", "kwargs": {}},
        "classifier": {"name": "ICarl", "kwargs": {"num_class": 8, "feat_dim": 512}},
        "optimizer": {"name": "SGD", "kwargs": {"lr": 0.05, "momentum": 0.9}},
    }).get_config_dict()
    method = ICarl(cfg, cuda)
    state = method.init_state(0, (32, 32, 3))
    state = method.after_task(state, 0, None)  # the teacher
    state = method.start_task(state, 1, 4, 8)
    state = method.reset_optimizer(state, 1)
    batch = {"image": torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 8, (8,), device=cuda), "weight": torch.ones(8, device=cuda)}
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    teacher = {k: v.clone() for k, v in state.mvars["teacher"].state_dict().items()}
    state, out = method.train_step(state, batch, 0.05)
    torch.cuda.synchronize()
    assert torch.isfinite(out["loss"])
    after = state.params.state_dict()
    assert not torch.equal(after["head.dense.weight"], before["head.dense.weight"])
    assert not torch.equal(after["backbone.bn_stem.running_mean"],
                           before["backbone.bn_stem.running_mean"])
    assert all(torch.equal(v, teacher[k]) for k, v in state.mvars["teacher"].state_dict().items())


# ----------------------------------------------------------------- LayerNorm

_BF, _F32 = torch.bfloat16, torch.float32
#: (leading shape, D, x dtype, output dtype, parameter dtype, eps): L2P's query
#: and prompted passes (the frozen bf16 ViT-B/16, block eps 1e-5; the final
#: norm into f32 at 1e-6), the CLIP text tower's ln_final (f32 parameters,
#: into f32), vit_tiny_test's D 64 in f32, and the kernels' edges: D 8, chunk
#: counts that leave lanes idle (D 136, 520), D 1024, f32 rows into bf16 and
#: the largest D in both input dtypes
LN_CASES = [((128, 197), 768, _BF, _BF, _BF, 1e-5), ((128, 222), 768, _BF, _BF, _BF, 1e-5),
            ((128, 222), 768, _BF, _F32, _BF, 1e-6), ((100, 77), 512, _BF, _F32, _F32, 1e-5),
            ((4, 17), 64, _F32, _F32, _F32, 1e-6), ((5, 3), 8, _BF, _BF, _BF, 1e-5),
            ((9,), 136, _BF, _BF, _F32, 1e-5), ((3, 11), 520, _F32, _BF, _BF, 1e-6),
            ((7, 5), 1024, _F32, _F32, _BF, 1e-5), ((3, 5), 4096, _BF, _BF, _F32, 1e-5),
            ((3, 5), 4096, _F32, _F32, _F32, 1e-5)]
#: dw and db, summed in f32 over every row in another order, relative to their
#: largest magnitude; in bf16 parameters two bf16 ulps, as TOL
LN_PARAM_TOL = {_F32: 1e-4, _BF: 1.6e-2}


def _ln_inputs(cuda, case, seed=4):
    lead, d, xdt, ydt, wdt, eps = case
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(*lead, d, device=cuda, generator=g) * 1.5 + 0.3).to(xdt)
    w = (1.0 + 0.2 * torch.randn(d, device=cuda, generator=g)).to(wdt)
    b = (0.1 * torch.randn(d, device=cuda, generator=g)).to(wdt)
    go = torch.randn(*lead, d, device=cuda, generator=g).to(ydt)
    return x, w, b, go, ydt, eps


def _bf16_ulp(t):
    """The spacing of bf16 values at each |t| (8 significant bits), no finer
    than at |t| = 2^-9 (2^-16): nearer 0 the f32 cancellation in xhat * w + b,
    a few f32 ulps of terms near 1, decides the rounding."""
    mag = t.float().abs()
    e = torch.where(mag > 0, torch.frexp(mag).exponent - 8, -16)
    return torch.ldexp(torch.ones_like(mag), e.clamp(min=-16))


@pytest.mark.parametrize("case", LN_CASES, ids=lambda c: "{}x{}-{}-{}-{}".format(
    "x".join(map(str, c[0])), c[1], *(str(t)[6:] for t in c[2:5])))
def test_layer_norm_kernels_match_plain(cuda, case):
    """The forward within one bf16 ulp of the plain version elementwise (an
    f32 output within TOL), the saved statistics, and dx, dw and db against
    the backward's equations in PyTorch (``layer_norm_bwd_plain``)."""
    x, w, b, go, ydt, eps = _ln_inputs(cuda, case)
    y, mean, rstd = LN.layer_norm_cuda(x, w, b, eps, ydt, stats=True)
    dx, dw, db = LN.layer_norm_bwd_cuda(x, go, w, mean, rstd, params=True)
    torch.cuda.synchronize()
    ref = LN.layer_norm_plain(x, w, b, eps, ydt)
    assert y.dtype == ydt and y.shape == x.shape
    if ydt == _BF:
        assert bool(((y.float() - ref.float()).abs() <= _bf16_ulp(ref)).all())
    else:
        assert _err(y, ref) <= TOL[_F32]
    ref_mean, ref_rstd = LN.layer_norm_stats_plain(x, eps)
    assert _err(mean, ref_mean) <= TOL[_F32] and _err(rstd, ref_rstd) <= TOL[_F32]
    ref_dx, ref_dw, ref_db = LN.layer_norm_bwd_plain(x, go, w, eps)
    assert dx.dtype == x.dtype and _err(dx, ref_dx) <= TOL[x.dtype]
    for got, want in ((dw, ref_dw), (db, ref_db)):
        assert got.dtype == w.dtype
        assert _err(got, want.to(w.dtype)) <= LN_PARAM_TOL[w.dtype]


@pytest.mark.parametrize("params", [False, True], ids=["dx", "dx-dw-db"])
def test_layer_norm_backward_is_deterministic(cuda, params):
    x, w, b, go, ydt, eps = _ln_inputs(cuda, LN_CASES[1])
    _, mean, rstd = LN.layer_norm_cuda(x, w, b, eps, ydt, stats=True)
    first = LN.layer_norm_bwd_cuda(x, go, w, mean, rstd, params=params)
    second = LN.layer_norm_bwd_cuda(x, go, w, mean, rstd, params=params)
    torch.cuda.synchronize()
    assert all((a is None and c is None) or torch.equal(a, c) for a, c in zip(first, second))


def test_layer_norm_autograd_matches_the_composition_and_saves_nothing_without_grad(cuda):
    """Through the op: under ``no_grad`` one forward launch and no graph;
    with a graph, the gradients asked for (x's and the trainable
    parameters'), each one launch, near autograd of the old composition."""
    x, w, b, go, ydt, eps = _ln_inputs(cuda, LN_CASES[3])
    LN.reset_launches()
    with torch.no_grad():
        y = LN.layer_norm(x.requires_grad_(), w, b, eps, ydt)
    assert y.grad_fn is None and LN.LAUNCHES == {"ln_fwd": 1, "ln_bwd": 0}
    w.requires_grad_()
    y = LN.layer_norm(x, w, b, eps, ydt)
    y.backward(go)
    assert LN.LAUNCHES == {"ln_fwd": 2, "ln_bwd": 1} and b.grad is None
    x2, w2 = x.detach().requires_grad_(), w.detach().requires_grad_()
    LN.layer_norm_plain(x2, w2, b, eps, ydt).backward(go)
    assert _err(x.grad, x2.grad) <= TOL[x.dtype]
    assert _err(w.grad, w2.grad) <= LN_PARAM_TOL[w.dtype]


def test_layer_norm_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    x = torch.zeros(4, 64, device=cuda)
    fwd = LN.layer_norm_cuda
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fwd(x.cpu(), w, b, 1e-5, _F32)
    for d in (20, 4104):
        with pytest.raises(ValueError, match=f"D {d} not supported"):
            fwd(torch.zeros(4, d, device=cuda), torch.ones(d, device=cuda),
                torch.zeros(d, device=cuda), 1e-5, _F32)
    with pytest.raises(TypeError, match="dtype"):
        fwd(x.half(), w, b, 1e-5, _F32)
    with pytest.raises(TypeError, match="output dtype"):
        fwd(x, w, b, 1e-5, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(torch.zeros(64, 4, device=cuda).t(), w, b, 1e-5, _F32)
    with pytest.raises(ValueError, match="does not match"):
        fwd(x, torch.ones(32, device=cuda), b, 1e-5, _F32)
    with pytest.raises(TypeError, match="bias dtype"):
        fwd(x, w, b.bfloat16(), 1e-5, _F32)
    with pytest.raises(ValueError, match="empty"):
        fwd(torch.zeros(0, 64, device=cuda), w, b, 1e-5, _F32)
    _, mean, rstd = fwd(x, w, b, 1e-5, _F32, stats=True)
    with pytest.raises(ValueError, match="gradient"):
        LN.layer_norm_bwd_cuda(x, torch.zeros(4, 32, device=cuda), w, mean, rstd)
    with pytest.raises(ValueError, match="mean"):
        LN.layer_norm_bwd_cuda(x, x, w, mean[:2], rstd)
    with pytest.raises(ValueError, match="nothing to compute"):
        LN.layer_norm_bwd_cuda(x, x, w, mean, rstd, dx=False)


def test_l2p_step_runs_every_layer_norm_through_the_kernels(cuda):
    """One L2P step on the full ViT-B/16 at batch 8: the frozen query pass
    (24 block norms and the final one) and the prompted pass launch 50
    forwards, and the prompted pass's backward 25 (the prompts enter before
    block 0), by ``LAUNCHES`` and by the tracer's launch record."""
    from collections import Counter

    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.methods.prompt_methods import L2P
    from libcontinual_tpu_torch.utils.trace import TRACER

    cfg = Config(overrides={
        "dataset": "synthetic", "data_root": "", "image_size": 32, "task_num": 10,
        "init_cls_num": 10, "inc_cls_num": 10, "batch_size": 8, "dtype": "bfloat16",
        "backbone": {"name": "ViTZoo", "kwargs": {}},
        "classifier": {"name": "L2P", "kwargs": {
            "num_class": 100, "feat_dim": 768, "init_cls_num": 10, "inc_cls_num": 10,
            "task_num": 10, "prompt_length": 5, "pool_size": 10, "top_k": 5,
            "pull_constraint_coeff": 0.1}},
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001875}},
    }).get_config_dict()
    method = L2P(cfg, cuda)
    state = method.init_state(0, (32, 32, 3))
    batch = {"image": torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 10, (8,), device=cuda), "weight": torch.ones(8, device=cuda)}
    LN.reset_launches()
    period = TRACER.begin()
    try:
        state, out = method.train_step(state, batch, 1e-3)
        torch.cuda.synchronize()
    finally:
        TRACER.end()
    assert torch.isfinite(out["loss"])
    assert LN.LAUNCHES == {"ln_fwd": 50, "ln_bwd": 25}
    shapes = Counter((kind, shape) for _, kind, shape in period.launches
                     if kind.startswith("ln_"))
    assert shapes == {("ln_fwd", (8 * 197, 768)): 25, ("ln_fwd", (8 * 222, 768)): 25,
                      ("ln_bwd", (8 * 222, 768)): 25}


def _recorded_prompt_step(cuda, classifier, kwargs):
    """One training step of a prompt method on the full ViT-B/16 at batch 128
    (32 px images, resized to 224 by the ViT preset), after one unrecorded
    step, inside a ``trainer.step`` span of a recording period: its rows."""
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.methods.prompt_methods import L2P, DualPrompt
    from libcontinual_tpu_torch.utils.trace import TRACER

    cfg = Config(overrides={
        "dataset": "synthetic", "data_root": "", "image_size": 224, "task_num": 10,
        "init_cls_num": 10, "inc_cls_num": 10, "batch_size": 128, "dtype": "bfloat16",
        "backbone": {"name": "ViTZoo", "kwargs": {}},
        "classifier": {"name": classifier, "kwargs": {
            "num_class": 100, "feat_dim": 768, "init_cls_num": 10, "inc_cls_num": 10,
            "task_num": 10, **kwargs}},
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.001}},
    }).get_config_dict()
    method = {"L2P": L2P, "DualPrompt": DualPrompt}[classifier](cfg, cuda)
    state = method.init_state(0, (32, 32, 3))
    batch = {"image": torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 10, (128,), device=cuda),
             "weight": torch.ones(128, device=cuda)}
    state, _ = method.train_step(state, batch, 1e-3)
    torch.cuda.synchronize()
    period = TRACER.begin()
    try:
        with TRACER.span("trainer.step"):
            state, out = method.train_step(state, batch, 1e-3)
        torch.cuda.synchronize()
    finally:
        TRACER.end()
    assert torch.isfinite(out["loss"])
    return period.rows()


def _one(rows, name):
    found = [r for r in rows if r["name"] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_dualprompt_step_launches_the_prefix_kernels_in_its_spans(cuda):
    """One DualPrompt step at the published widths, batch 128: no host sync
    in ``trainer.step``; the prefix kernels forward and backward in blocks
    0-1 (3 prompt keys) and 2-4 (10), the qkv kernels in the other seven and
    the query pass; ``step.query`` and ``step.prompts`` once each, inside
    ``step.forward``."""
    from collections import Counter

    rows = _recorded_prompt_step(cuda, "DualPrompt", {
        "e_prompt_length": 20, "g_prompt_length": 6, "pool_size": 10})
    step = _one(rows, "trainer.step")
    assert step["syncs"] == 0
    attn = Counter((k, s) for k, s in step["launches"] if k.endswith(("qkv_fwd", "qkv_bwd")))
    assert attn == {("pqkv_fwd", (128, 197, 3, 768, 12)): 2,
                    ("pqkv_fwd", (128, 197, 10, 768, 12)): 3,
                    ("pqkv_bwd", (128, 197, 3, 768, 12)): 2,
                    ("pqkv_bwd", (128, 197, 10, 768, 12)): 3,
                    ("qkv_fwd", (128, 197, 768, 12)): 12 + 7,
                    ("qkv_bwd", (128, 197, 768, 12)): 7}
    forward = _one(rows, "step.forward")
    query, prompts = _one(rows, "step.query"), _one(rows, "step.prompts")
    assert query["parent"] == prompts["parent"] == forward["id"]
    assert not [k for k, _ in query["launches"] if k.startswith("pqkv")]


def test_l2p_step_shows_its_query_pass_and_no_prefix_launch(cuda):
    rows = _recorded_prompt_step(cuda, "L2P", {
        "prompt_length": 5, "pool_size": 10, "top_k": 5, "pull_constraint_coeff": 1.0})
    step = _one(rows, "trainer.step")
    assert step["syncs"] == 0
    assert not [k for k, _ in step["launches"] if k.startswith("pqkv")]
    forward = _one(rows, "step.forward")
    assert _one(rows, "step.query")["parent"] == forward["id"]
    assert _one(rows, "step.prompts")["parent"] == forward["id"]


# ------------------------------------------------ generic attention forward

#: the bf16-score variant (fast_bf16sm): a sum-order difference that flips
#: the bf16 rounding of one score moves that key's weight by up to
#: 2^(2^-5) - 1 = 2.2% at |s| < 8, in either dtype
BF16SM_TOL = 3e-2
# (B, H, Sq, Skv, hd): Skv > Sq, Skv < Sq, Skv past 256 keys at hd 128, Sq == Skv;
# hd 8 and 20 (16 and 40 bytes a row: the first copied in 16-byte chunks, the
# second element by element); the tensor-core tiles' edges at hd 64 (a warp's
# 16 query rows, a block's 64 queries, the 64-key tiles) and at hd 128
G_SHAPES = [(2, 3, 9, 13, 8), (1, 2, 17, 5, 16), (2, 1, 33, 300, 128), (2, 3, 70, 70, 32),
            (2, 3, 33, 20, 20), (2, 2, 16, 16, 64), (2, 2, 64, 65, 64), (2, 2, 65, 128, 64),
            (2, 2, 128, 64, 64), (2, 2, 65, 65, 128)]
G_CASES = [(shape, fn) for shape in G_SHAPES
           for fn in ["attention", *T.VARIANTS] if fn != "flash" or shape[2] == shape[3]]


def _generic_inputs(cuda, shape, dtype, seed=2):
    """q, k, v as (B, H, S, hd) views of (B, S, H, hd) tensors (strided, as
    a caller's .transpose(1, 2) gives them)."""
    b, h, sq, skv, hd = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, s, h, hd, device=cuda, generator=g).to(dtype).transpose(1, 2)
                 for s in (sq, skv, skv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", G_CASES)
def test_generic_kernel_and_variants_match_plain(cuda, dtype, case):
    shape, fn = case
    q, k, v = _generic_inputs(cuda, shape, dtype)
    scale = shape[-1] ** -0.5
    if fn == "attention":
        out, ref = T.attention_cuda(q, k, v, scale), T.attention_plain(q, k, v, scale)
    else:
        out = T.attention_variant_cuda(q, k, v, scale, fn)
        ref = T.attention_variant_plain(q, k, v, scale, fn)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype and out.is_contiguous()
    assert _err(out, ref) <= (BF16SM_TOL if fn == "fast_bf16sm" else TOL[dtype])


def test_generic_forward_is_deterministic(cuda):
    """The bf16 forward twice on the same inputs at a main-path shape (the
    ViT-B/16 width at S 197), in each mode: bitwise-equal outputs."""
    q, k, v = _generic_inputs(cuda, (4, 12, 197, 197, 64), torch.bfloat16)
    scale = 64 ** -0.5
    calls = {"attention": lambda: T.attention_cuda(q, k, v, scale)}
    calls.update({fn: lambda fn=fn: T.attention_variant_cuda(q, k, v, scale, fn)
                  for fn in T.VARIANTS})
    for fn, call in calls.items():
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second), fn


def test_generic_autograd_launches_the_kernel_never_the_plain_version(cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain forward ran on a CUDA tensor")

    monkeypatch.setattr(T, "attention_plain", refuse)
    q, k, v = (t.detach().requires_grad_() for t in
               _generic_inputs(cuda, (2, 3, 9, 13, 64), torch.bfloat16))
    go = torch.randn(2, 3, 9, 64, device=cuda, dtype=torch.bfloat16)
    T.reset_launches()
    out = T.fused_attention(q, k, v)
    out.backward(go)
    assert T.LAUNCHES == {**dict.fromkeys(T.LAUNCHES, 0), "attn_fwd": 1}
    T.attention(q, k, v, 0.3)
    assert T.LAUNCHES["attn_fwd"] == 2
    ref = T.attention_bwd(q.detach(), k.detach(), v.detach(), go, 64 ** -0.5)
    for leaf, r in zip((q, k, v), ref):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, r)


def test_generic_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    q, k, v = _generic_inputs(cuda, (1, 2, 5, 7, 160), torch.float32)
    with pytest.raises(ValueError, match="head dim 160"):
        T.fused_attention(q, k, v)
    q, k, v = _generic_inputs(cuda, (1, 2, 5, 7, 64), torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        T.fused_attention(q, k, v)
    with pytest.raises(TypeError, match="not supported"):
        T.attention_variant_cuda(q, k, v, 0.1, "v2")
    q, k, v = _generic_inputs(cuda, (1, 2, 5, 7, 64), torch.float32)
    every_other = torch.randn(1, 2, 5, 128, device=cuda)[..., ::2]  # head dim stride 2
    with pytest.raises(ValueError, match="contiguous"):
        T.attention_cuda(every_other, k[:, :, :5], v[:, :, :5], 0.1)
    with pytest.raises(ValueError, match="expected q"):
        T.attention_cuda(q, k, v[:, :, :3], 0.1)
    with pytest.raises(ValueError, match="Sq == Skv"):
        T.attention_variant_cuda(q, k, v, 0.1, "flash")


# ------------------------------------------------------- the tracer on CUDA

#: a 2-task L2P run of a tiny ViT, as the CPU trainer tests run it
TRACE_OVERRIDES = {
    "dataset": "synthetic", "data_root": "", "image_size": 32,
    "task_num": 2, "init_cls_num": 4, "inc_cls_num": 4,
    "epoch": 2, "batch_size": 16, "per_class": 24, "seed": 7,
    "val_per_epoch": 0, "testing_times": 1, "dtype": "float32",
    "augment": False, "mesh": {"data": 1, "model": 1},
    "backbone": {"name": "vit_tiny_test", "kwargs": {}},
    "classifier": {"name": "L2P", "kwargs": {
        "num_class": 8, "feat_dim": 64, "init_cls_num": 4, "inc_cls_num": 4,
        "task_num": 2, "prompt_length": 3, "pool_size": 6, "top_k": 2,
        "pull_constraint_coeff": 0.1}},
    "train_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
    "test_trfms": [{"Normalize": {"mean": [0.5] * 3, "std": [0.25] * 3}}],
    "buffer": {"name": "LinearBuffer",
               "kwargs": {"buffer_size": 0, "batch_size": 16, "strategy": "random"}},
    "optimizer": {"name": "Adam", "kwargs": {"lr": 0.01}},
    "lr_scheduler": {"name": "Constant"}, "warmup": 0, "profile": True,
}

#: a fresh process: nothing has touched CUDA when the trainer's period
#: begins; closed spans' events are resolved every 8 (``RESOLVE_AT``)
PROFILE_RUN = """
import json, sys, torch
from libcontinual_tpu_torch.config import Config
from libcontinual_tpu_torch.core.trainer import Trainer
from libcontinual_tpu_torch.utils import trace
trace.RESOLVE_AT = 8
cfg = Config(overrides=json.loads(sys.argv[1])).get_config_dict()
assert not torch.cuda.is_initialized()
Trainer(cfg, device="cuda").train_loop()
period = trace.TRACER.periods[-1]
held = sum(s.ev0 is not None for s in period.spans)
rows = period.rows()
keys = ("name", "id", "parent", "device_start_ms", "device_end_ms", "device_ms", "syncs")
print(json.dumps({"mode": torch.cuda.get_sync_debug_mode(), "held": held,
                  "rows": [{k: r[k] for k in keys} for r in rows]}))
"""


def test_profile_run_records_device_times_and_syncs(cuda, tmp_path):
    """A ``profile: true`` run begins its period before CUDA starts; the
    spans after it still carry device times, nested as the spans are, and
    count the epoch drain's host copies as syncs; the run ends holding few
    events, and the sync debug mode is put back."""
    cfg = dict(TRACE_OVERRIDES, save_path=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", PROFILE_RUN, json.dumps(cfg)], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["mode"] == 0
    rows = got["rows"]
    steps = [r for r in rows if r["name"] == "trainer.step"]
    drains = [r for r in rows if r["name"] == "epoch.drain"]
    assert len(steps) == 24 and len(drains) == 4
    assert all(r["device_ms"] is not None and r["device_ms"] > 0 for r in steps)
    assert all(r["syncs"] >= 1 for r in drains)
    by_id = {r["id"]: r for r in rows}
    for r in rows:
        parent = by_id.get(r["parent"])
        if parent is not None and parent["name"] == "trainer.step":
            assert parent["device_start_ms"] <= r["device_start_ms"] <= r["device_end_ms"]
            assert r["device_end_ms"] <= parent["device_end_ms"]
    assert len(rows) > 150 and got["held"] < 40
    with open(os.path.join(str(tmp_path), "events.jsonl"), encoding="utf-8") as fin:
        spans = [e for e in map(json.loads, fin) if e["kind"] == "span"]
    assert [e["device_ms"] for e in spans if e["name"] == "trainer.step"] == [
        r["device_ms"] for r in steps]
