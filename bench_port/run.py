#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch port once and print its result.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: ``workloads/<cell>.json`` names its
configuration, traffic and driver; ``configs/<config>.json`` holds the
port's configuration and ``configs/<config>.py`` its operation count,
weights and plain reference; ``traffic/<traffic>.json`` the generator's
sizes; ``drivers/<driver>.py`` the set-up and the window; and
``metrics/<metric>.py`` each per-layer metric's reader. ``BENCHMARK.json``
at the repository root says which metrics the cell reports.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number with its limit);
the checks are also the last lines of standard error. Without a CUDA
device, or with fewer than the cell asks for, it exits with 2 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
#: build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}


def _set_cache_dirs() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(REPO, "build", "bench_port", sub)
    # one host thread for PyTorch's CPU ops: the steps are dispatched by one
    # Python thread, and a pool of eight spinning beside it on a shared host
    # moved the host-bound cells' rates by 10-17% between runs
    os.environ["OMP_NUM_THREADS"] = "1"


def _read_json(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as fin:
        return json.load(fin)


def load_module(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell: str, bench: Dict):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def resolve(cell: str, bench_dir: str = BENCH_DIR, bench: Optional[Dict] = None):
    """The cell's files, loaded by name."""
    if bench is None:
        bench = _read_json(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    wl = _read_json(os.path.join(bench_dir, "workloads", f"{cell}.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"cell {cell!r} is not in BENCHMARK.json")
    if (entry["config"], entry["traffic"]) != (wl["config"], wl["traffic"]):
        raise ValueError(f"{cell}: BENCHMARK.json and workloads/{cell}.json disagree")
    e2e, per_layer = metrics_of(cell, bench)
    return types.SimpleNamespace(
        name=cell, cell=wl, chips=int(entry["chips"]),
        config_file=_read_json(os.path.join(bench_dir, "configs", f"{wl['config']}.json")),
        cfgmod=load_module(os.path.join(bench_dir, "configs", f"{wl['config']}.py"),
                           f"bench_config_{wl['config']}"),
        traffic=_read_json(os.path.join(bench_dir, "traffic", f"{wl['traffic']}.json")),
        driver=load_module(os.path.join(bench_dir, "drivers", f"{wl['driver']}.py"),
                           f"bench_driver_{wl['driver']}"),
        e2e=e2e, per_layer=per_layer,
        readers={m["name"]: load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                                        f"bench_metric_{m['name']}") for m in per_layer},
    )


def port_config(r, seed: int) -> Dict:
    """The port's configuration dict: the file's, over the port's defaults,
    with the run's seed and the traffic's batch size."""
    from libcontinual_tpu_torch.config import Config

    cfg = Config(overrides=r.config_file["config"]).get_config_dict()
    cfg["seed"] = int(seed) % (2 ** 31 - 1)
    cfg["save_path"] = ""
    if "batch_size" in r.traffic:
        cfg["batch_size"] = int(r.traffic["batch_size"])
    return cfg


def _power_limit() -> Optional[str]:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else None


def _parse(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, device: str = "cuda",
         bench_dir: str = BENCH_DIR, bench: Optional[Dict] = None) -> int:
    """Run the cell; ``device="cpu"`` (tests) skips the look for a card."""
    args = _parse(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    r = resolve(args.workload, bench_dir, bench)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < r.chips:
            print(f"{args.workload} needs {r.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    # the port's command line runs float32 products in full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = types.SimpleNamespace(
        cell=r.cell, config=port_config(r, args.seed), traffic=r.traffic, cfgmod=r.cfgmod,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START,
    )
    res = r.driver.run(ctx)

    if args.trace:
        metrics = {}
        for m in r.per_layer:
            value = r.readers[m["name"]].read(res.get("trace", {}))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in r.e2e}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": r.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if device == "cuda":
        dev["power_limit"] = _power_limit()
    line = {"correct": False, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        t = res.get("trace", {})
        dev.update(busy_s=t.get("busy_s", 0.0), window_s=t.get("window_s", 0.0))
        line["breakdown"] = {"device_ops": t.get("device_ops", []),
                             "idle_gaps": t.get("idle_gaps", [])}
    from bench_port import check

    ok, rows = check.judge(res["checks"], r.cell["limits"])
    line["correct"] = ok and res["failed"] == 0
    line["checks"] = {row["name"]: {"value": row["value"], "limit": row["limit"]}
                      for row in rows}
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in res.get("phases", {}).items()),
          file=sys.stderr)
    for row in rows:
        print(f"check {row['name']} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    _set_cache_dirs()
    sys.exit(main())
