#!/usr/bin/env python
"""GPU smoke run of the PyTorch port (``libcontinual_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; it raises without them. Phases, each of
which raises on failure:

  1. environment: torch, CUDA, the card's name and power limit;
  2. build: the CUDA kernels from ``libcontinual_tpu_torch/ops/csrc``;
  3. forward check: the packed-qkv attention kernel against its plain
     PyTorch version, at a small odd shape (f32 and bf16) and at the L2P
     main-path shapes (B 16, S 197 and 222, D 768, 12 heads, bf16);
  4. backward check: the autograd gradient through the kernels against the
     plain backward, at the same shapes;
  5. the slice: the port's ``Trainer`` (the code behind
     ``python -m libcontinual_tpu_torch``) runs L2P on a full-width
     ViT-B/16 from random init, 2 tasks of 10 synthetic classes stored at
     32 px and resized to 224 in the step; then one full-width batch goes
     through the kernels and through the plain attention, and the two agree;
  6. timing: the steady-state L2P train step at the bench geometry (batch
     128, bf16, 32 -> 224), and each kernel against its plain version at
     B 128, S 222.

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

import numpy as np
import torch

# bf16 kernels: the plain version has the same rounding points, so only a
# sum-order difference that flips one bf16 rounding can show: two bf16 ulps
# at the largest magnitude of the reference. f32: summation order only.
TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
# one full-width batch through 12 bf16 blocks, kernels vs plain attention:
# per-layer one-ulp differences compound through the residual stream
SLICE_TOL = 5e-2

SMALL = (2, 17, 64, 4)  # (B, S, D, heads)
MAIN = [(16, 197, 768, 12), (16, 222, 768, 12)]
TIMED = (128, 222, 768, 12)

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


# ------------------------------------------------------------------ phases


def phase_build():
    from libcontinual_tpu_torch.ops import _build
    from libcontinual_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    A._lib()
    print(f"[build] qkv_attention built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path('qkv_attention')})")
    log_path = _build.library_path("qkv_attention") + ".ptxas.txt"
    with open(log_path) as f:
        log = f.read()
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
    spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"[build] ptxas: {len(regs)} kernels, at most {max(regs, default=0)} registers "
          f"a thread, at most {max(spills, default=0)} bytes of spill stores ({log_path})")


def _inputs(shape, dtype, dev, seed):
    b, s, d, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * d, device=dev, generator=g).to(dtype)
    go = torch.randn(b, s, d, device=dev, generator=g).to(dtype)
    return qkv, go


def phase_checks(dev, errs):
    from libcontinual_tpu_torch.ops import attention as A

    cases = [(SMALL, torch.float32), (SMALL, torch.bfloat16)]
    cases += [(shape, torch.bfloat16) for shape in MAIN]
    for i, (shape, dtype) in enumerate(cases):
        b, s, d, h = shape
        scale = (d // h) ** -0.5
        qkv, go = _inputs(shape, dtype, dev, seed=i)
        out = A.qkv_attention_cuda(qkv, scale, h)
        torch.cuda.synchronize()
        abs_f, rel_f = _err(out, A.qkv_attention_plain(qkv, scale, h))
        x = qkv.clone().requires_grad_()
        A.fused_qkv_attention(x, scale, h).backward(go)
        torch.cuda.synchronize()
        abs_b, rel_b = _err(x.grad, A.qkv_attention_bwd_plain(qkv, go, scale, h))
        tag = f"B {b} S {s} D {d} H {h} {str(dtype).split('.')[-1]}"
        print(f"[fwd check] {tag}: max abs err {abs_f:.3e}, scaled {rel_f:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        print(f"[bwd check] {tag}: max abs err {abs_b:.3e}, scaled {rel_b:.3e} "
              f"(tolerance {TOL[dtype]:.1e})")
        _require(rel_f <= TOL[dtype], f"forward kernel disagrees at {tag}")
        _require(rel_b <= TOL[dtype], f"backward kernel disagrees at {tag}")
        if shape in MAIN:
            errs["qkv_fwd"] = max(errs["qkv_fwd"], abs_f)
            errs["qkv_bwd"] = max(errs["qkv_bwd"], abs_b)


def _slice_config():
    cfg = copy.deepcopy(BENCH_CONFIG)
    cfg.update(task_num=2, batch_size=32, per_class=8, val_per_epoch=0)
    cfg["classifier"]["kwargs"].update(num_class=20, task_num=2)
    return cfg


def phase_slice(dev):
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.core.trainer import Trainer
    from libcontinual_tpu_torch.ops import attention as A

    cfg = Config(overrides=_slice_config()).get_config_dict()
    trainer = Trainer(cfg, device=dev)
    state = trainer.state
    frozen0 = {k: v.clone() for k, v in state.mvars["frozen"].state_dict().items()}
    params0 = {k: v.clone() for k, v in state.params.state_dict().items()}
    losses = []
    trainer.epoch_hook = lambda t, e, s, step_losses: losses.append(np.asarray(step_losses))

    A.reset_launches()
    res = trainer.train_loop()
    torch.cuda.synchronize()
    launches = dict(A.LAUNCHES)

    steps = sum(len(x) for x in losses)
    table = res["acc_table"]
    print(f"[slice] {steps} train steps, losses {np.concatenate(losses).round(4).tolist()}")
    print(f"[slice] acc table {table.tolist()}, last avg acc {res['last_avg_acc']}")
    print(f"[slice] kernel launches in the run: {launches}")
    _require(steps > 0 and all(np.isfinite(x).all() for x in losses), "non-finite loss")
    _require(table.shape == (2, 2) and np.isfinite(table).all(), "acc table not filled")
    frozen1 = trainer.state.mvars["frozen"].state_dict()
    _require(all(torch.equal(v, frozen1[k]) for k, v in frozen0.items()), "frozen ViT changed")
    params1 = trainer.state.params.state_dict()
    for name in ("head.dense.weight", "prompt.prompt", "prompt.key"):
        _require(not torch.equal(params0[name], params1[name]), f"{name} did not train")
    depth = len(trainer.state.mvars["frozen"].blocks)  # 12 at ViT-B/16
    # every step runs both ViT passes forward and the prompted pass backward
    _require(launches["qkv_fwd"] >= 2 * depth * steps, "forward kernel launched too rarely")
    _require(launches["qkv_bwd"] >= depth * steps, "backward kernel launched too rarely")
    return trainer, launches


class _PlainQKV(torch.autograd.Function):
    """The plain forward and backward as one autograd function, for the
    kernels-vs-plain comparison of a whole batch."""

    @staticmethod
    def forward(ctx, qkv, scale, heads):
        from libcontinual_tpu_torch.ops import attention as A

        ctx.save_for_backward(qkv)
        ctx.scale, ctx.heads = scale, heads
        return A.qkv_attention_plain(qkv, scale, heads)

    @staticmethod
    def backward(ctx, g):
        from libcontinual_tpu_torch.ops import attention as A

        (qkv,) = ctx.saved_tensors
        return A.qkv_attention_bwd_plain(qkv, g.contiguous(), ctx.scale, ctx.heads), None, None


@contextlib.contextmanager
def _plain_attention():
    """Within it, the ViT's attention calls go to the plain version."""
    from libcontinual_tpu_torch.models import vit

    saved = vit.fused_qkv_attention
    vit.fused_qkv_attention = _PlainQKV.apply
    try:
        yield
    finally:
        vit.fused_qkv_attention = saved


def phase_slice_reference(trainer, dev):
    """One full-width batch through the trained state's two ViT passes, with
    the kernels and with the plain attention: query features, prompted
    features and the prompt gradient agree. The prompts are fixed (pool
    entries 0..k-1), so no discrete choice sits between the two runs."""
    state, method = trainer.state, trainer.method
    td = trainer.test_stream.task(0)
    x = method.augment(None, torch.from_numpy(td.images[:8]).to(dev), train=False)
    pool = state.params["prompt"]
    frozen = state.mvars["frozen"]

    def run():
        pool.zero_grad(set_to_none=True)
        q = method.frozen_query(frozen, x)
        prompts = pool.prompt[: method.top_k].reshape(1, -1, pool.prompt.shape[-1])
        out = frozen(x, prepend_tokens=prompts.expand(x.shape[0], -1, -1),
                     feature_mode="prompt_mean")
        out["features"].square().sum().backward()
        return q.detach(), out["features"].detach(), pool.prompt.grad.detach().clone()

    got = run()
    with _plain_attention():
        ref = run()
    for name, a, b in zip(("query features", "prompted features", "prompt grad"), got, ref):
        scaled = float((a - b).norm() / b.norm())
        print(f"[slice ref] {name}: relative L2 error {scaled:.3e} (tolerance {SLICE_TOL})")
        _require(torch.isfinite(a).all() and scaled <= SLICE_TOL, f"{name} disagree")


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


def phase_kernel_timing(dev, card):
    from libcontinual_tpu_torch.ops import attention as A

    b, s, d, h = TIMED
    scale = (d // h) ** -0.5
    qkv, go = _inputs(TIMED, torch.bfloat16, dev, seed=7)
    times = {
        # plain, kernel, kernel, plain: neither gets only the warm or cold turn
        "plain_fwd_1": _time_cuda(lambda: A.qkv_attention_plain(qkv, scale, h)),
        "fwd_1": _time_cuda(lambda: A.qkv_attention_cuda(qkv, scale, h)),
        "fwd_2": _time_cuda(lambda: A.qkv_attention_cuda(qkv, scale, h)),
        "plain_fwd_2": _time_cuda(lambda: A.qkv_attention_plain(qkv, scale, h)),
        "plain_bwd_1": _time_cuda(lambda: A.qkv_attention_bwd_plain(qkv, go, scale, h)),
        "bwd_1": _time_cuda(lambda: A.qkv_attention_bwd_cuda(qkv, go, scale, h)),
        "bwd_2": _time_cuda(lambda: A.qkv_attention_bwd_cuda(qkv, go, scale, h)),
        "plain_bwd_2": _time_cuda(lambda: A.qkv_attention_bwd_plain(qkv, go, scale, h)),
    }
    out = {}
    for k in ("fwd", "bwd"):
        ms = min(times[f"{k}_1"], times[f"{k}_2"])
        plain = min(times[f"plain_{k}_1"], times[f"plain_{k}_2"])
        out[k] = (ms, plain)
        print(f"[timing] qkv_{k} at B {b} S {s} D {d} H {h} bf16: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms (all runs {json.dumps({x: round(y, 4) for x, y in times.items() if k in x})}) "
              f"[{card}]")
    return out


def phase_step_timing(dev, card, n_steps=20):
    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.methods.prompt_methods import L2P

    cfg = Config(overrides=copy.deepcopy(BENCH_CONFIG)).get_config_dict()
    method = L2P(cfg, dev)
    state = method.init_state(1993, (32, 32, 3))
    rng = np.random.RandomState(0)
    bs = cfg["batch_size"]
    batch = {
        "image": torch.from_numpy(rng.randint(0, 255, (bs, 32, 32, 3)).astype(np.uint8)).to(dev),
        "label": torch.from_numpy(rng.randint(0, 10, (bs,))).to(dev),
        "weight": torch.ones(bs, device=dev),
    }

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
    print(f"[timing] L2P train step, ViT-B/16 bf16, batch {bs}, 32->224: "
          f"{kernel:.2f} and {kernel2:.2f} img/s with the kernels, {plain:.2f} img/s "
          f"with the plain attention; peak memory {peak:.2f} GiB [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    phase_build()
    errs = {"qkv_fwd": 0.0, "qkv_bwd": 0.0}
    phase_checks(dev, errs)
    trainer, launches = phase_slice(dev)
    phase_slice_reference(trainer, dev)
    del trainer
    torch.cuda.empty_cache()
    times = phase_kernel_timing(dev, card)
    phase_step_timing(dev, card)

    src = "libcontinual_tpu_torch/ops/csrc/qkv_attention.cu"
    kernels = [
        {"name": "qkv_fwd", "route": "cuda", "source": src,
         "replaces": "libcontinual_tpu/ops/attention.py:140",
         "launches": launches["qkv_fwd"], "max_abs_err": errs["qkv_fwd"],
         "ms": times["fwd"][0], "plain_ms": times["fwd"][1]},
        {"name": "qkv_bwd", "route": "cuda", "source": src,
         "replaces": "libcontinual_tpu/ops/attention.py:222",
         "launches": launches["qkv_bwd"], "max_abs_err": errs["qkv_bwd"],
         "ms": times["bwd"][0], "plain_ms": times["bwd"][1]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
