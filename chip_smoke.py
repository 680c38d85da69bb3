#!/usr/bin/env python
"""GPU smoke run of the PyTorch port (``libcontinual_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; it raises without them. Phases, each of
which raises on failure:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: both kernel libraries from ``libcontinual_tpu_torch/ops/csrc``
     (``qkv_attention``, ``prefix_attention``), compiled at once, with each
     one's ptxas report;
  3. kernel checks, forward and backward, against the plain PyTorch versions:
     the packed-qkv kernels at a small odd shape (f32, bf16) and at the
     slices' shapes (B 16, S 197, 202 and 222, D 768, 12 heads, bf16); the
     prefix-KV kernels at a small odd shape (f32, bf16), at the DualPrompt
     and CODA shapes (B 16, S 197, P 3, 4 and 10, bf16), with a prompt
     broadcast over the batch (batch stride 0) and with one that differs per
     image;
  4. the slices: the port's ``Trainer`` (the code behind
     ``python -m libcontinual_tpu_torch``) runs L2P, DualPrompt, CODA-Prompt
     and DAP (on a long-tailed ``imb_type: exp`` stream) on a full-width
     ViT-B/16 from random init, each for 2 tasks of 10 synthetic classes
     stored at 32 px and resized to 224 in the step, with the launch counts
     and the launch shapes of each run (every shape must be one that phase 3
     checked); then one full-width batch goes through the trained L2P,
     DualPrompt and DAP states with the kernels and with the plain
     attention, and the two agree;
  5. timing: each kernel against its plain version and against
     ``scaled_dot_product_attention`` (the yardstick, which the port never
     calls) at the main path's shapes, and the L2P and DualPrompt train steps
     at the bench geometry (batch 128, bf16, 32 -> 224) with the kernels and
     with the plain attention, plus a device-time breakdown of the DualPrompt
     step from ``torch.profiler``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# parameters that must move in a slice's run
TRAINED = {
    "L2P": ("head.dense.weight", "prompt.prompt", "prompt.key"),
    "DualPrompt": ("head.dense.weight", "prompt.g_p_0", "prompt.e_p_2", "prompt.e_k_2"),
    "CodaPrompt": ("head.dense.weight", "prompt.e_p_0", "prompt.e_k_0", "prompt.e_a_0"),
    "DAP": ("head.dense.weight", "prompt.taskprompt", "prompt.generalprompt"),
}
PREFIX_BLOCKS = 5  # DualPrompt and CODA-Prompt put prefixes on blocks 0-4


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
    from libcontinual_tpu_torch.ops import prefix_attention as PA

    return A, PA


def _reset_launches() -> None:
    A, PA = _attention_modules()
    A.reset_launches()
    PA.reset_launches()


def _launches() -> dict:
    A, PA = _attention_modules()
    return {**A.LAUNCHES, **PA.LAUNCHES}


def _shape_key(kname, qkv, *rest):
    """(kernel, S, [P,] D, heads, dtype) of one launch: what a check at that
    shape covers, whatever the batch."""
    s, d, heads = qkv.shape[1], qkv.shape[2] // 3, rest[-1]
    p = (rest[0].shape[1],) if kname.startswith("pqkv") else ()
    return (kname, s, *p, d, heads, qkv.dtype)


@contextlib.contextmanager
def _recorded_shapes(seen: set):
    """Within it, every launch of a kernel wrapper adds its ``_shape_key`` to
    ``seen``; the wrappers themselves run (and count) as before."""
    A, PA = _attention_modules()
    wrapped = [(A, "qkv_attention_cuda", "qkv_fwd"), (A, "qkv_attention_bwd_cuda", "qkv_bwd"),
               (PA, "prefix_attention_cuda", "pqkv_fwd"),
               (PA, "prefix_attention_bwd_cuda", "pqkv_bwd")]
    saved = [getattr(mod, attr) for mod, attr, _ in wrapped]

    def recording(fn, kname):
        def call(*args):
            seen.add(_shape_key(kname, *args))
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


def phase_build():
    from libcontinual_tpu_torch.ops import _build

    A, PA = _attention_modules()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per library, started together
        list(pool.map(lambda mod: mod._lib(), (A, PA)))
    print(f"[build] both libraries built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in ("qkv_attention", "prefix_attention"):
        log_path = _build.library_path(name) + ".ptxas.txt"
        with open(log_path) as f:
            log = f.read()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {name} ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, at most {max(spills, default=0)} bytes of spill stores "
              f"({log_path})")


def _inputs(shape, dtype, dev, seed):
    b, s, d, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * d, device=dev, generator=g).to(dtype)
    go = torch.randn(b, s, d, device=dev, generator=g).to(dtype)
    return qkv, go


def phase_checks(dev, errs, checked):
    """The packed-qkv kernels against their plain versions; adds the
    ``_shape_key`` of each checked shape to ``checked``."""
    A, _ = _attention_modules()
    cases = [(SMALL, torch.float32), (SMALL, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in MAIN]
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
    _, PA = _attention_modules()
    cases = [(P_SMALL, torch.float32, "image"), (P_SMALL, torch.bfloat16, "image"),
             (P_SMALL, torch.float32, "broadcast")]
    cases += [(shape, torch.bfloat16, "image") for shape in P_MAIN]
    cases += [(P_MAIN[0], torch.bfloat16, "broadcast")]
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


def _slice_config(name):
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
    frozen0 = {k: v.clone() for k, v in state.mvars["frozen"].state_dict().items()}
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
    frozen1 = trainer.state.mvars["frozen"].state_dict()
    _require(all(torch.equal(v, frozen1[k]) for k, v in frozen0.items()),
             f"{name}: frozen ViT changed")
    params1 = trainer.state.params.state_dict()
    for pname in TRAINED[name]:
        _require(not torch.equal(params0[pname], params1[pname]), f"{name}: {pname} did not train")
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
    return trainer, launches, steps


class _PlainQKV(torch.autograd.Function):
    """The plain forward and backward as one autograd function, for the
    kernels-vs-plain comparison of a whole batch."""

    @staticmethod
    def forward(ctx, qkv, scale, heads):
        A, _ = _attention_modules()
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.heads = scale, heads
        return A.qkv_attention_plain(qkv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        A, _ = _attention_modules()
        (qkv,) = ctx.saved_tensors
        return A.qkv_attention_bwd_plain(qkv, g.contiguous(), ctx.scale, ctx.heads), None, None


class _PlainPrefix(torch.autograd.Function):
    """The plain prefix-KV forward and backward as one autograd function."""

    @staticmethod
    def forward(ctx, qkv, pk, pv, scale, heads):
        _, PA = _attention_modules()
        ctx.save_for_backward(qkv, pk, pv)
        ctx.scale, ctx.heads = scale, heads
        return PA.prefix_attention_plain(qkv, pk, pv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        _, PA = _attention_modules()
        qkv, pk, pv = ctx.saved_tensors
        grads = PA.prefix_attention_bwd_plain(qkv, pk, pv, g.contiguous(), ctx.scale, ctx.heads)
        return (*grads, None, None)


@contextlib.contextmanager
def _plain_attention():
    """Within it, the ViT's attention calls (with and without a prefix) go to
    the plain versions."""
    from libcontinual_tpu_torch.models import vit

    saved = vit.fused_qkv_attention, vit.fused_prefix_attention
    vit.fused_qkv_attention, vit.fused_prefix_attention = _PlainQKV.apply, _PlainPrefix.apply
    try:
        yield
    finally:
        vit.fused_qkv_attention, vit.fused_prefix_attention = saved


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


def _time_pair(label, runs, card):
    """``runs`` maps plain/library/kernel to a function; each is timed
    twice in the order plain, library, kernel, kernel, library, plain, and
    the better of the two is kept."""
    order = ["plain", "library", "kernel", "kernel", "library", "plain"]
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(_time_cuda(runs[k]))
    best = {k: min(v) for k, v in times.items()}
    print(f"[timing] {label}: kernel {best['kernel']:.4f} ms, plain {best['plain']:.4f} ms, "
          f"sdpa {best['library']:.4f} ms (all runs "
          f"{json.dumps({k: [round(x, 4) for x in v] for k, v in times.items()})}) [{card}]")
    return best


def _sdpa_runs(q, k, v, go_h, scale):
    """SDPA forward, and its backward alone (forward + backward minus the
    forward, measured by the caller); inputs built outside the timed window."""
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        return torch.autograd.grad(out, (qg, kg, vg), go_h)

    return fwd, fwd_bwd


def phase_kernel_timing(dev, card):
    A, PA = _attention_modules()
    out = {}
    # packed qkv at the L2P prompted pass
    b, s, d, h = TIMED
    scale = (d // h) ** -0.5
    qkv, go = _inputs(TIMED, torch.bfloat16, dev, seed=7)
    q, k, v = (_heads(qkv[..., i * d:(i + 1) * d], h) for i in range(3))
    sdpa_fwd, sdpa_fb = _sdpa_runs(q, k, v, _heads(go, h), scale)
    tag = f"B {b} S {s} D {d} H {h} bf16"
    fwd = _time_pair(f"qkv_fwd at {tag}", {
        "plain": lambda: A.qkv_attention_plain(qkv, scale, h),
        "library": sdpa_fwd,
        "kernel": lambda: A.qkv_attention_cuda(qkv, scale, h)}, card)
    bwd = _time_pair(f"qkv_bwd at {tag} (sdpa: forward + backward)", {
        "plain": lambda: A.qkv_attention_bwd_plain(qkv, go, scale, h),
        "library": sdpa_fb,
        "kernel": lambda: A.qkv_attention_bwd_cuda(qkv, go, scale, h)}, card)
    bwd["library"] -= fwd["library"]
    per_image = s * 3 * d + s * d
    out["qkv_fwd"] = (fwd, _bound(2 * b * per_image, 4 * b * h * s * s * (d // h)))
    out["qkv_bwd"] = (bwd, _bound(2 * b * (per_image + s * 3 * d), 10 * b * h * s * s * (d // h)))
    del qkv, go, q, k, v

    # prefix-KV at the DualPrompt e-prompt blocks
    b, s, p, d, h = P_TIMED
    scale = (d // h) ** -0.5
    qkv, pk, pv, go = _prefix_inputs(P_TIMED, torch.bfloat16, dev, seed=8, layout="image")
    pk, pv = pk.contiguous(), pv.contiguous()
    q = _heads(qkv[..., :d], h)
    k = _heads(torch.cat([pk, qkv[..., d:2 * d]], dim=1), h)
    v = _heads(torch.cat([pv, qkv[..., 2 * d:]], dim=1), h)
    sdpa_fwd, sdpa_fb = _sdpa_runs(q, k, v, _heads(go, h), scale)
    tag = f"B {b} S {s} P {p} D {d} H {h} bf16"
    fwd = _time_pair(f"pqkv_fwd at {tag}", {
        "plain": lambda: PA.prefix_attention_plain(qkv, pk, pv, scale, h),
        "library": sdpa_fwd,
        "kernel": lambda: PA.prefix_attention_cuda(qkv, pk, pv, scale, h)}, card)
    bwd = _time_pair(f"pqkv_bwd at {tag} (sdpa: forward + backward)", {
        "plain": lambda: PA.prefix_attention_bwd_plain(qkv, pk, pv, go, scale, h),
        "library": sdpa_fb,
        "kernel": lambda: PA.prefix_attention_bwd_cuda(qkv, pk, pv, go, scale, h)}, card)
    bwd["library"] -= fwd["library"]
    bound_fwd, bound_bwd = _pqkv_bounds(b, s, p, d, h)
    out["pqkv_fwd"], out["pqkv_bwd"] = (fwd, bound_fwd), (bwd, bound_bwd)
    for name, (_, (bound_ms, by)) in out.items():
        print(f"[bound] {name}: {bound_ms * 1e3:.1f} us, bound by {by}")
    for other in (3, 4):  # the g-prompt and CODA prefix lengths
        (f_ms, f_by), (b_ms, b_by) = _pqkv_bounds(b, s, other, d, h)
        print(f"[bound] pqkv at P {other}: forward {f_ms * 1e3:.1f} us ({f_by}), "
              f"backward {b_ms * 1e3:.1f} us ({b_by})")
    return out


def _step_setup(dev, name):
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.registry import METHODS

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
    print(f"[timing] {name} train step, ViT-B/16 bf16, batch {bs}, 32->224: "
          f"{kernel:.2f} and {kernel2:.2f} img/s with the kernels, {plain:.2f} img/s "
          f"with the plain attention; peak memory {peak:.2f} GiB [{card}]")
    if profile:
        _profile_step(method, state, batch, name, card)


def _profile_step(method, state, batch, name, card, steps=3):
    """Device time per step by kernel, over ``steps`` steps after warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        method.train_step(state, batch, 1e-3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            method.train_step(state, batch, 1e-3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops repeat the time of the kernels they launch
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, evt.count / steps, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    attn = sum(r[0] for r in rows if "lct::attn_" in r[2])
    print(f"[profile] {name} step: {total:.3f} ms of kernel time a step ({attn:.3f} ms in the "
          f"attention kernels) in {wall_ms:.3f} ms of profiled wall time (kernels "
          f"{100 * total / wall_ms:.1f}% of it) [{card}]")
    for ms, calls, key in rows[:14]:
        print(f"[profile]   {ms:9.3f} ms  {calls:6.1f} calls  {key[:110]}")


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
    errs = {"qkv_fwd": 0.0, "qkv_bwd": 0.0, "pqkv_fwd": 0.0, "pqkv_bwd": 0.0}
    checked, seen = set(), set()
    phase_checks(dev, errs, checked)
    phase_prefix_checks(dev, errs, checked)

    launches = {}
    for name in ("L2P", "DualPrompt", "CodaPrompt", "DAP"):
        trainer, launches[name], _ = phase_slice(dev, name, seen)
        if name in ("L2P", "DAP"):
            phase_slice_reference(trainer, dev, name)
        elif name == "DualPrompt":
            phase_prefix_slice_reference(trainer, dev)
        del trainer
        torch.cuda.empty_cache()
    # every shape the slices gave a kernel was checked against the plain version
    print(f"[slices] kernel shapes launched (kernel, S, [P,] D, heads, dtype): "
          f"{sorted(map(str, seen))}")
    _require(not seen - checked, f"kernels launched at unchecked shapes: {seen - checked}")

    times = phase_kernel_timing(dev, card)
    phase_step_timing(dev, card, "L2P")
    phase_step_timing(dev, card, "DualPrompt", profile=True)
    print(f"[env] all phases in {time.perf_counter() - t_start:.1f} s")

    csrc = "libcontinual_tpu_torch/ops/csrc/"
    sources = {"qkv": csrc + "qkv_attention.cu", "pqkv": csrc + "prefix_attention.cu"}
    replaces = {"qkv_fwd": 140, "qkv_bwd": 222, "pqkv_fwd": 348, "pqkv_bwd": 394}
    kernels = []
    for kname, line in replaces.items():
        best, (bound_ms, by) = times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname.split("_")[0]],
            "replaces": f"libcontinual_tpu/ops/attention.py:{line}",
            # this slice's main path, DualPrompt, runs all four kernels
            "launches": launches["DualPrompt"][kname],
            "launches_by_path": {p: n[kname] for p, n in launches.items()},
            "max_abs_err": errs[kname], "ms": best["kernel"], "plain_ms": best["plain"],
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3, "bound_by": by,
            "library_ms": best["library"],
        })
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
