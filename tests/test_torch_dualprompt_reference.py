"""The benchmark's DualPrompt configuration on the CPU
(``bench_port/configs/dualprompt_vit_b16.py``): the port's ``DualPrompt``,
run through the benchmark's set-up of a training cell on the small test ViT
in float32, against the plain reference, with the check that decides
``correct`` (``bench_port/check.py``); the configuration's leaves and
operation count; and the readers of its two per-layer metrics on hand-made
records.

``vit_tiny_test`` has 4 blocks, so block 4's E-prompt has no block: its
prefix goes nowhere in the program and in the reference, and its key still
counts in the matching term. Blocks 0-3 hold both kinds of prompt."""

from __future__ import annotations

import copy
import json
import os
import shutil
import types

import pytest
import torch

from bench_port import check, run, weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_port")
CONFIG = "dualprompt_vit_b16"
CELL = "dualprompt_vit_b16.tiny"
SEED = 2 ** 31 + 4099
#: the configuration's changes for the CPU: the 4-block test ViT at 32 px,
#: float32, two tasks of ten classes, batches of 8 (the set-up records 3 steps)
TINY = {"backbone": {"name": "vit_tiny_test", "kwargs": {}}, "image_size": 32, "task_num": 2,
        "dtype": "float32",
        "train_trfms": [
            {"RandomResizedCrop": {"size": 32, "scale": [0.05, 1.0], "ratio": [0.75, 1.3333]}},
            {"RandomHorizontalFlip": {"p": 0.5}}, {"ToTensor": {}}],
        "test_trfms": [{"ToTensor": {}}]}
TINY_KWARGS = {"num_class": 20, "task_num": 2, "feat_dim": 64}
TRAFFIC = {"num_classes": 20, "per_class": 16, "test_per_class": 4, "image_size": 32,
           "noise": 0.35, "batch_size": 8, "task": 0}
#: Both sides compute in float32 from the same weights, batches and
#: augmentation draws; they differ in the order of their sums (fused
#: attention and LayerNorm against plain matmuls and softmax), about 1e-7
#: relative a product. ``loss``: that order through two passes, 1e-5.
#: ``grad``: the prompts' gradients sum over the batch and the heads as well,
#: 1e-4. ``change``: Adam divides each gradient by its own root mean square,
#: so an entry of small gradient moves by a full step either way; 1e-3.
TOL = {"loss": 1e-5, "grad": 1e-4, "change": 1e-3}


def _read(path):
    with open(path, "r", encoding="utf-8") as fin:
        return json.load(fin)


def _write(path, obj):
    with open(path, "w", encoding="utf-8") as fout:
        json.dump(obj, fout)


def _tiny_config():
    cfg = _read(os.path.join(BENCH, "configs", f"{CONFIG}.json"))
    cfg["config"].update(copy.deepcopy(TINY))
    cfg["config"]["classifier"]["kwargs"].update(TINY_KWARGS)
    return cfg


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The harness copied with the tiny cell added as new files, resolved."""
    bench_dir = str(tmp_path_factory.mktemp("bench") / "bench_port")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    name = f"{CONFIG}_tiny"
    _write(os.path.join(bench_dir, "configs", f"{name}.json"), _tiny_config())
    shutil.copy(os.path.join(BENCH, "configs", f"{CONFIG}.py"),
                os.path.join(bench_dir, "configs", f"{name}.py"))
    _write(os.path.join(bench_dir, "traffic", f"{name}.json"), TRAFFIC)
    wl = _read(os.path.join(BENCH, "workloads", f"{CONFIG}.train_b128.json"))
    _write(os.path.join(bench_dir, "workloads", f"{CELL}.json"),
           dict(wl, config=name, traffic=name, profile_steps=2))
    bench = _read(os.path.join(REPO, "BENCHMARK.json"))
    bench["configs"].append({"name": name, "source": "test", "file": "", "reduced": []})
    bench["workloads"].append({"name": CELL, "config": name, "traffic": name, "chips": 1,
                               "why": "test"})
    return run.resolve(CELL, bench_dir, bench)


@pytest.fixture(scope="module")
def program(cell):
    """The program's first steps through the cell's set-up, recorded; the
    configuration, weights and augmentation seed the reference follows."""
    config = run.port_config(cell, SEED)
    ctx = types.SimpleNamespace(cell=cell.cell, config=config, traffic=cell.traffic,
                                cfgmod=cell.cfgmod, seed=SEED, seconds=0.0, trace=False,
                                device="cpu", t_start=0.0)
    s = cell.driver.setup(ctx)
    return config, s["weights"], s["rec"], s["aug_seed"], s["task"]


def _within(values):
    return all(values[n] <= limit for n, limit in TOL.items())


def test_the_program_agrees_with_the_plain_reference(cell, program):
    config, made, rec, aug, task = program
    assert len(rec["losses"]) == 3 and all(torch.isfinite(torch.tensor(rec["losses"])))
    ref = cell.cfgmod.reference(config, made, rec["batches"], aug, task)
    values = check.readings(rec, ref)
    assert _within(values), values


@pytest.mark.parametrize("control", ["fp8", "half"])
def test_the_tolerances_see_the_control_and_the_half_batch(cell, program, control):
    """The reference in e4m3 products, and with half of every batch left out,
    put in the program's place, fall outside the tolerances."""
    config, made, rec, aug, task = program
    ref = cell.cfgmod.reference(config, made, rec["batches"], aug, task)
    other = cell.cfgmod.reference(config, made, rec["batches"], aug, task, control=control)
    values = check.readings(other, ref)
    assert not _within(values), values


def test_a_reference_without_block_2s_prefix_fails(cell, program, monkeypatch):
    """The prefix mechanism is visible: a reference that drops block 2's
    E-prompt prefix (its matching term kept) falls outside the tolerances."""
    config, made, rec, aug, task = program
    kept = cell.cfgmod._prefixes

    def without_block_2(sh, P, t):
        out = kept(sh, P, t)
        assert 2 in out
        del out[2]
        return out

    monkeypatch.setattr(cell.cfgmod, "_prefixes", without_block_2)
    values = check.readings(rec, cell.cfgmod.reference(config, made, rec["batches"], aug, task))
    assert not _within(values), values


def test_the_spec_installs_into_the_programs_state(cell):
    """Every leaf of the weight spec has its place in the program's state, at
    its shape, and every parameter of the state is given."""
    from libcontinual_tpu_torch.methods.prompt_methods import DualPrompt

    config = run.port_config(cell, SEED)
    state = DualPrompt(config, "cpu").init_state(0, (32, 32, 3))
    spec = cell.cfgmod.weight_spec(config)
    made = weights.make(spec, SEED, "cpu")
    assert set(made) == set(cell.cfgmod.GROUPS)
    for group, values in made.items():
        weights.install(cell.cfgmod.GROUPS[group](state), values)
    names = {n for _, n, *_ in spec}
    assert {f"prompt.g_p_{g}" for g in (0, 1)} | {f"prompt.e_{k}_{e}" for k in "pk"
                                                  for e in (2, 3, 4)} <= names
    assert all(t.dtype == torch.float32 for t in made["params"].values())


def test_flops_at_the_published_widths():
    """The query pass at S 197, the prompted pass with 3 keys in front of
    blocks 0-1 and 10 in front of blocks 2-4, its backward through all 12
    blocks, two patch embeddings and the head: within 1% of 106.2 GFLOP."""
    cfg = _read(os.path.join(BENCH, "configs", f"{CONFIG}.json"))["config"]
    mod = run.load_module(os.path.join(BENCH, "configs", f"{CONFIG}.py"), "count_dualprompt")
    d, s = 768, 197
    proj = 2 * s * d * (4 * d + 2 * 3072)
    keys = [s + 3] * 2 + [s + 10] * 3 + [s] * 7
    hand = (12 * (proj + 4 * s * s * d) + sum(2 * proj + 12 * s * n * d for n in keys)
            + 2 * 2 * 196 * 768 * d + 3 * 2 * d * 100)
    assert hand == 106_643_625_984
    assert mod.flops_per_image(cfg, {"task": 0}) == hand
    assert abs(hand / 106.2e9 - 1.0) < 0.01


# ------------------------------------------------------- metric readers

def _reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", f"{name}.py"), f"reader_{name}")


#: device names as the profiler printed them on an H100 (one DualPrompt step):
#: the one-pass attention kernels <MODE, KEYS>, modes 0 qkv, 1 prefix, 2 masked;
#: the streaming ones <T, HDP, MODE> by the same template, whose path the cell
#: does not take; a LayerNorm kernel and a cuBLAS GEMM
_FWD = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, long, long, "
        "float const*, __nv_bfloat16*, int, int, int, int, float, bool)")
_BWD = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, long, long, "
        "float const*, __nv_bfloat16 const*, __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, "
        "int, int, int, int, float, bool, bool, bool)")
KERNELS = [
    (f"void lct::attn_fwd_kernel<1, 256>{_FWD}", 2e-4),
    (f"void lct::attn_bwd_dkdv_kernel<1, 256>{_BWD}", 5e-4),
    (f"void lct::attn_fwd_kernel<0, 256>{_FWD}", 7e-4),
    (f"void lct::attn_bwd_dkdv_kernel<0, 256>{_BWD}", 9e-4),
    (f"void lct::attn_fwd_kernel<__nv_bfloat16, 64, 1>{_FWD}", 1e-4),
    (f"void lct::attn_bwd_dq_kernel<__nv_bfloat16, 64, 2>{_BWD}", 3e-4),
    (f"void lct::attn_bwd_dkdv_kernel<float, 64, 0>{_BWD}", 4e-4),
    ("void lct::ln_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 3>(__nv_bfloat16 const*, void "
     "const*, void const*, int, __nv_bfloat16*, float*, float*, int, int, float)", 6e-4),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 8e-3),
]
PREFIX = (128, 197, 10, 768, 12)


def test_prefix_attn_roofline_reads_only_the_prefix_mode():
    from bench_port import bounds

    read = _reader("prefix_attn_roofline")
    assert [read.mode_of(n) for n, _ in KERNELS] == [1, 1, 0, 0, 1, 2, 0, None, None]
    launches = [("pqkv_fwd", PREFIX), ("pqkv_bwd", PREFIX), ("qkv_fwd", (128, 197, 768, 12)),
                ("ln_fwd", (128 * 197, 768))]
    fwd, bwd = bounds.pqkv_bounds(*PREFIX)
    # the bounds of the two prefix launches over the three mode-1 kernels' 8e-4 s
    got = read.read({"launches": launches, "kernels": KERNELS})
    assert got == pytest.approx(100.0 * (fwd + bwd) / 8e-4)


def test_prefix_attn_roofline_reads_none_without_prefix_launches():
    read = _reader("prefix_attn_roofline").read
    qkv_only = [("qkv_fwd", (128, 222, 768, 12)), ("qkv_bwd", (128, 222, 768, 12))]
    assert read({"launches": qkv_only, "kernels": KERNELS}) is None
    assert read({"launches": [("pqkv_fwd", PREFIX)], "kernels": KERNELS[2:4]}) is None
    assert read({}) is None


def _period_rows():
    """Three steps, 10 ms each on the device: ``step.forward`` holds
    ``step.query`` (3, 4 and 5 ms) and ``step.prompts``."""
    rows, nid = [], 0
    for i, q in enumerate((3.0, 4.0, 5.0)):
        start = 20.0 * i
        step, fwd = nid + 1, nid + 2
        rows += [{"name": "trainer.step", "id": step, "parent": None, "device_start_ms": start,
                  "device_end_ms": start + 10.0, "device_ms": 10.0, "syncs": 0},
                 {"name": "step.forward", "id": fwd, "parent": step, "device_start_ms": start,
                  "device_end_ms": start + 6.0, "device_ms": 6.0, "syncs": 0},
                 {"name": "step.query", "id": nid + 3, "parent": fwd, "device_start_ms": start,
                  "device_end_ms": start + q, "device_ms": q, "syncs": 0},
                 {"name": "step.prompts", "id": nid + 4, "parent": fwd,
                  "device_start_ms": start + q, "device_end_ms": start + q + 0.1,
                  "device_ms": 0.1, "syncs": 0}]
        nid += 4
    return rows


def test_query_device_pct_reads_a_hand_made_period():
    share = _reader("query.device_pct").share
    rows = _period_rows()
    # the first step is left out: the median of 4/10 and 5/10
    assert share(rows) == pytest.approx(45.0)
    assert share([r for r in rows if r["name"] != "step.query"]) is None
    assert share(None) is None
    for r in rows:
        r["device_start_ms"] = r["device_end_ms"] = r["device_ms"] = None
    assert share(rows) is None
