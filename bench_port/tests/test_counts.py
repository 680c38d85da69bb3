"""The harness's arithmetic against hand counts: model operations an image,
the attention bounds, the idle share."""

import json
import os

import pytest

from bench_port import bounds, trace
from bench_port.run import load_module
from tiny import BENCH


def _config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json"), encoding="utf-8") as fin:
        cfg = json.load(fin)["config"]
    return cfg, load_module(os.path.join(BENCH, "configs", f"{name}.py"), f"count_{name}")


def test_l2p_vit_b16_flops():
    cfg, mod = _config("l2p_vit_b16")
    # a block at S tokens: 2 S D (3D + D + 2 * 3072) for the projections,
    # 4 S^2 D for attention's two products (8 S^2 D for its backward's four)
    d = 768
    proj = lambda s: 2 * s * d * (3 * d + d + 2 * 3072)  # noqa: E731
    query = proj(197) + 4 * 197 ** 2 * d  # 2,907,909,120
    prompted = proj(222) + 4 * 222 ** 2 * d  # 3,293,982,720
    backward = proj(222) + 8 * 222 ** 2 * d  # 3,445,383,168
    embed = 2 * 196 * 768 * d  # each forward's patch embedding
    head = 3 * 2 * d * 100
    hand = 12 * (query + prompted + backward) + 2 * embed + head
    assert hand == 116_230_182_912
    assert mod.flops_per_image(cfg, {"task": 0}) == hand


def test_icarl_resnet32_flops():
    cfg, mod = _config("icarl_resnet32")
    # multiply-adds: the stem, stage 1 (10 convs at 32x32), stages 2 and 3
    # (a strided 3x3, a 1x1 projection and nine 3x3 at 16x16 and 8x8), head
    stem = 9 * 3 * 16 * 1024
    stage1 = 10 * 9 * 16 * 16 * 1024
    stage2 = 9 * 16 * 32 * 256 + 16 * 32 * 256 + 9 * 9 * 32 * 32 * 256
    stage3 = 9 * 32 * 64 * 64 + 32 * 64 * 64 + 9 * 9 * 64 * 64 * 64
    macs = stem + stage1 + stage2 + stage3 + 64 * 100
    assert macs == 69_130_496
    assert mod.forward_macs(cfg) == macs
    # student forward + backward (three forwards) and, from task 1, the teacher
    assert mod.flops_per_image(cfg, {"task": 0}) == 3 * 2 * macs
    assert mod.flops_per_image(cfg, {"task": 1}) == 4 * 2 * macs


def test_attention_bounds_match_the_kernel_table():
    fwd, bwd = bounds.qkv_bounds(128, 222, 768, 12)
    assert fwd * 1e6 == pytest.approx(52.1, abs=0.05)
    assert bwd * 1e6 == pytest.approx(91.2, abs=0.05)
    assert bounds.launch_bound("qkv_fwd", (128, 222, 768, 12)) == fwd
    assert bounds.launch_bound("qkv_bwd", (128, 222, 768, 12)) == bwd
    assert bounds.pqkv_bounds(128, 197, 10, 768, 12)[0] * 1e6 == pytest.approx(47.4, abs=0.05)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_idle_share_is_the_union_of_kernel_intervals():
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 0.0, 2.0),
        _ev("kernel", "a", 10.0, 30.0),   # 10-40
        _ev("kernel", "b", 20.0, 10.0),   # inside a: counts once
        _ev("gpu_memcpy", "copy", 35.0, 15.0),  # 35-50, overlaps a
        _ev("kernel", "c", 70.0, 20.0),   # 70-90, after a gap
        _ev("cpu_op", "aten::mm", 55.0, 10.0),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 90.0, 10.0),  # the window ends at 100
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(60e-6)  # 10-50 and 70-90
    assert s["gaps"] == [(0.0, 10.0), (50.0, 70.0), (90.0, 100.0)]
    assert [k for k, _ in s["kernels"]] == ["a", "b", "c"]
    assert s["device_ops"][0] == ["a", pytest.approx(30e-6)]
    labels = trace.label_gaps(events, s["gaps"])
    assert labels[0] == ["aten::mm", pytest.approx(20e-6)]
    idle = load_module(os.path.join(BENCH, "metrics", "device.idle_pct.train.py"), "idle")
    assert idle.read(s) == pytest.approx(40.0)


def test_roofline_reader():
    rl = load_module(os.path.join(BENCH, "metrics", "attn_roofline.py"), "rl")
    fwd, bwd = bounds.qkv_bounds(128, 222, 768, 12)
    t = {"launches": [("qkv_fwd", (128, 222, 768, 12)), ("qkv_bwd", (128, 222, 768, 12))],
         "kernels": [("void attn_fwd_kernel<__nv_bfloat16, 64, 0>(...)", 4 * fwd),
                     ("void attn_bwd_dq_kernel<__nv_bfloat16, 64, 0>(...)", 2 * bwd),
                     ("void attn_bwd_dkdv_kernel<__nv_bfloat16, 64, 0>(...)", 2 * bwd),
                     ("ampere_bf16_s16816gemm", 1.0)]}
    assert rl.read(t) == pytest.approx(100.0 * (fwd + bwd) / (4 * fwd + 4 * bwd))
    assert rl.read({"launches": [], "kernels": t["kernels"]}) is None
