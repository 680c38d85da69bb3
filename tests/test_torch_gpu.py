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
    assert T.LAUNCHES == {**dict.fromkeys(T.LAUNCHES, 0), "qkv_fwd": 1, "qkv_bwd": 1}


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
    PT.reset_launches()
    PT.fused_prefix_attention(qkv, pk, pv, 0.25, 4).float().sum().backward()
    assert PT.LAUNCHES == {"pqkv_fwd": 1, "pqkv_bwd": 1}
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


@pytest.mark.parametrize("family", ["qkv", "prefix", "masked"])
def test_backward_is_deterministic(cuda, family):
    """Two calls on the same inputs give the same bits: no atomics, every
    sum in a fixed order (bf16, several query and key tiles)."""
    qkv, mask, go = _masked_inputs(cuda, (3, 150, 4, 64), torch.bfloat16, "random")
    _, pk, pv, _ = _prefix_inputs(cuda, (3, 150, 10, 4, 64), torch.bfloat16, "image")

    def call():
        if family == "qkv":
            return [T.qkv_attention_bwd_cuda(qkv, go, 0.125, 4)]
        if family == "prefix":
            return list(PT.prefix_attention_bwd_cuda(qkv, pk, pv, go, 0.125, 4))
        return [MT.masked_attention_bwd_cuda(qkv, mask, go, 0.125, 4)]

    first, second = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
    MT.reset_launches()
    method.train_step(state, batch, 1e-3)
    torch.cuda.synchronize()
    depth = len(state.params["clip"].text.blocks)
    assert MT.LAUNCHES == {"mqkv_fwd": depth, "mqkv_bwd": depth - 1}


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
