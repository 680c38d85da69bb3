#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 11,12,13 [--controls 3]

For each seed it runs the cell's set-up (the trainer at its task with the
benchmark's weights, the first steps recorded), frees the program and
follows the recorded steps with the plain reference; it prints one JSON line
of the three compared numbers for

* ``program``: the program against the float32 reference (sound runs: the
  lower readings);
* ``control``: the reference with its products in float8 e4m3 put in the
  program's place, on the first ``--controls`` seeds;
* ``half``: the reference with half of every batch left out, the mean taken
  over the rest, in the program's place, on the same seeds;
* ``correct``: each of those judged by ``check.judge`` against the cell's
  limits, as a run judges the program: the control and the fault have to
  come out false.

A step that returns the state unchanged reads 1 on ``change`` by
construction and needs no run. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH_DIR))

from bench_port import check, run  # noqa: E402


def readings(r, seed: int, controls: bool, device: str = "cuda", dtype: str = ""):
    config = run.port_config(r, seed)
    if dtype:  # a witness: the program in another precision than the configuration's
        config["dtype"] = dtype
    ctx = types.SimpleNamespace(cell=r.cell, config=config, traffic=r.traffic,
                                cfgmod=r.cfgmod, seed=seed, seconds=0.0, trace=False,
                                device=device, t_start=time.perf_counter())
    s = r.driver.setup(ctx)
    made, rec, aug, task = s["weights"], s["rec"], s["aug_seed"], s["task"]
    del s
    r.driver.free(device)
    ref = r.cfgmod.reference(ctx.config, made, rec["batches"], aug, task)
    out = {"seed": seed, "dtype": ctx.config["dtype"], "program": check.readings(rec, ref),
           "losses": rec["losses"], "ref_losses": ref["losses"],
           "worst_grad": check.worst_leaves(rec, ref, "grad"),
           "worst_change": check.worst_leaves(rec, ref, "change")}
    if controls:
        for kind in ("fp8", "half"):
            other = r.cfgmod.reference(ctx.config, made, rec["batches"], aug, task, control=kind)
            out["control" if kind == "fp8" else kind] = check.readings(other, ref)
    out["correct"] = {k: check.judge(out[k], r.cell["limits"])[0]
                      for k in ("program", "control", "half") if k in out}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--dtype", default="", help="run the program in this dtype (a witness)")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = run.resolve(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(r, seed, i < args.controls, dtype=args.dtype)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    run._set_cache_dirs()
    sys.exit(main())
