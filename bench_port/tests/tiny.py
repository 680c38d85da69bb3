"""Small copies of the benchmark's cells that a CPU test run can hold: the
same configurations and check, the port's small test ViT in place of
ViT-B/16, a few images a class, batches of 8, float32."""

from __future__ import annotations

import copy
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TRAFFIC = {"num_classes": 20, "per_class": 16, "test_per_class": 4, "image_size": 32,
           "noise": 0.35, "batch_size": 8}
# the cells, each with its configuration's changes for the CPU
CELLS = {
    "l2p_vit_b16.tiny": ("l2p_vit_b16", 0, {
        "backbone": {"name": "vit_tiny_test", "kwargs": {}}, "image_size": 32, "task_num": 2,
        "dtype": "float32",
        "train_trfms": [
            {"RandomResizedCrop": {"size": 32, "scale": [0.05, 1.0], "ratio": [0.75, 1.3333]}},
            {"RandomHorizontalFlip": {"p": 0.5}}, {"ToTensor": {}}],
        "test_trfms": [{"ToTensor": {}}]},
        {"num_class": 20, "task_num": 2, "feat_dim": 64}),
    "icarl_resnet32.tiny": ("icarl_resnet32", 1, {
        "task_num": 2, "dtype": "float32",
        "buffer": {"name": "LinearHerdingBuffer", "kwargs": {"buffer_size": 40, "batch_size": 8}}},
        {"num_class": 20, "task_num": 2}),
}


def _read(path):
    with open(path, "r", encoding="utf-8") as fin:
        return json.load(fin)


def _write(path, obj):
    with open(path, "w", encoding="utf-8") as fout:
        json.dump(obj, fout, indent=1)


def bench_tree(tmp: str):
    """A copy of the harness under ``tmp`` with the tiny cells added as new
    files; returns (bench_dir, BENCHMARK dict)."""
    bench_dir = os.path.join(tmp, "bench_port")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = copy.deepcopy(_read(os.path.join(REPO, "BENCHMARK.json")))
    for cell, (config, task, changes, kwargs) in CELLS.items():
        real = f"{config}.train_b128" if config.startswith("l2p") else f"{config}.train"
        name = f"{config}_tiny"
        cfg = _read(os.path.join(BENCH, "configs", f"{config}.json"))
        cfg["config"].update(copy.deepcopy(changes))
        cfg["config"]["classifier"]["kwargs"].update(kwargs)
        _write(os.path.join(bench_dir, "configs", f"{name}.json"), cfg)
        shutil.copy(os.path.join(BENCH, "configs", f"{config}.py"),
                    os.path.join(bench_dir, "configs", f"{name}.py"))
        _write(os.path.join(bench_dir, "traffic", f"{name}.json"), {**TRAFFIC, "task": task})
        wl = _read(os.path.join(BENCH, "workloads", f"{real}.json"))
        wl.update(config=name, traffic=name, profile_steps=2)
        _write(os.path.join(bench_dir, "workloads", f"{cell}.json"), wl)
        bench["configs"].append({"name": name, "source": "test", "file": "", "reduced": []})
        bench["workloads"].append({"name": cell, "config": name, "traffic": name, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and real in m["workloads"]:
                m["workloads"].append(cell)
    return bench_dir, bench
