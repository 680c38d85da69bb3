"""The harness is found by name and stands apart from the JAX package."""

import ast
import copy
import json
import os
import shutil

from bench_port import run
from tiny import BENCH, REPO


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as fin:
        return json.load(fin)


def test_a_new_cell_is_found_by_name(tmp_path):
    bench_dir = str(tmp_path / "bench_port")
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, files in os.walk(bench_dir) for p in files}
    # the new cell: one new workloads file, one new traffic file, one entry
    with open(os.path.join(bench_dir, "traffic", "task2_b64.json"), "w") as fout:
        json.dump({"task": 2, "batch_size": 64}, fout)
    with open(os.path.join(bench_dir, "workloads", "icarl_resnet32.task2.json"), "w") as fout:
        json.dump({"config": "icarl_resnet32", "traffic": "task2_b64", "driver": "train",
                   "limits": {"loss": 1, "grad": 1, "change": 1}}, fout)
    bench = copy.deepcopy(_bench())
    bench["workloads"].append({"name": "icarl_resnet32.task2", "config": "icarl_resnet32",
                               "traffic": "task2_b64", "chips": 1, "why": "test"})
    r = run.resolve("icarl_resnet32.task2", bench_dir, bench)
    assert r.traffic == {"task": 2, "batch_size": 64}
    assert r.cfgmod.flops_per_image(r.config_file["config"], r.traffic) > 0
    assert hasattr(r.driver, "run")
    assert {m["name"] for m in r.e2e} == {"setup_s"}
    assert set(r.readers) == {m["name"] for m in r.per_layer}
    for dp, _, files in os.walk(bench_dir):
        for p in files:
            if p in before:
                assert open(os.path.join(dp, p), "rb").read() == before[p]


def test_every_cell_resolves():
    bench = _bench()
    for w in bench["workloads"]:
        r = run.resolve(w["name"])
        assert r.cell["driver"] and r.cell["limits"]
        for m in r.per_layer:
            assert m["moves"] in {e["name"] for e in r.e2e}


FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "libcontinual_tpu")
FORBIDDEN_FILES = ("bench.py", "BENCH_r0", "MULTICHIP_r0", "BASELINE.json", "tools/")


def test_no_jax_and_no_jax_benchmark_files():
    for dp, _, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dp, name)
            src = open(path, encoding="utf-8").read()
            for node in ast.walk(ast.parse(src)):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] not in FORBIDDEN_MODULES, (path, m)
            if os.path.basename(dp) != "tests":
                for word in FORBIDDEN_FILES:
                    assert word not in src, (path, word)
