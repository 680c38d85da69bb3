"""CLI entry point of the PyTorch port:

    python -m libcontinual_tpu_torch --config <name> [--seed N] [--overrides k=v ...]

The config name is glob-resolved under ./configs/** (or ./config/**) as in
``run_trainer.py``. The run takes place on one CUDA device (``--device``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def resolve_config(name: str) -> str:
    if os.path.isfile(name):
        return name
    for root in ("configs", "config"):
        hits = sorted(
            glob.glob(os.path.join(root, "**", name + ".yaml"), recursive=True)
        ) + sorted(glob.glob(os.path.join(root, "**", name), recursive=True))
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise SystemExit(f"ambiguous config '{name}': {hits}")
    raise SystemExit(f"config '{name}' not found under ./configs or ./config")


def parse_value(text: str):
    """A YAML-like scalar or flow value: JSON (numbers, lists, objects),
    true/false/null in any case, else the string itself."""
    low = text.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    try:
        return json.loads(text)
    except ValueError:
        return text


def parse_overrides(items):
    out = {}
    for it in items or []:
        k, _, v = it.partition("=")
        out[k] = parse_value(v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m libcontinual_tpu_torch")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", nargs="*", default=None,
                   help="extra key=value config overrides")
    args = p.parse_args(argv)

    import torch

    from libcontinual_tpu_torch.config import Config
    from libcontinual_tpu_torch.core.trainer import Trainer

    # float32 configs mean full float32 products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = parse_overrides(args.overrides)
    if args.seed is not None:
        overrides["seed"] = args.seed
    config = Config(resolve_config(args.config), overrides=overrides).get_config_dict()
    Trainer(config, device=args.device).train_loop()


if __name__ == "__main__":
    main()
