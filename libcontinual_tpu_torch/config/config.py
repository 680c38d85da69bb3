"""Config: the default chain, a user YAML file and overrides, merged as in
``libcontinual_tpu/config/config.py``.

The default chain is kept here as a Python dict (the content of
``libcontinual_tpu/config/default.yaml``), so ``Config(overrides=...)`` needs
no YAML parser. PyYAML is imported only inside :func:`_read_yaml`, when a
config file is actually read.

Merge priority (low -> high): defaults < user yaml < overrides; the merge
replaces whole top-level values. ``includes:`` entries are merged in first,
resolved relative to the including file, then the search directories.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Optional

REPO_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs",
)

DEFAULTS: Dict[str, Any] = {
    "save_path": "",
    "dataset": "cifar100",
    "data_root": "",
    "image_size": 32,
    "augment": True,
    "num_workers": 0,
    "pin_memory": False,
    "device_ids": "auto",
    "n_gpu": 1,
    "seed": 1993,
    "deterministic": True,
    "epoch": 50,
    "batch_size": 64,
    "val_per_epoch": 1,
    "buffer": {
        "name": "LinearBuffer",
        "kwargs": {"buffer_size": 0, "batch_size": 128, "strategy": "herding"},
    },
    "optimizer": {"name": "SGD", "kwargs": {"lr": 0.1}},
    "lr_scheduler": {"name": "Constant"},
    "warmup": 0,
    "testing_times": 1,
    "setting": "task-agnostic",
    "testing_per_task": True,
    "eval_with_test": True,
    "mesh": {"data": -1, "model": 1},
    "dtype": "bfloat16",
    "epoch_scan": True,
    "checkpoint": {"enable": False, "dir": "", "keep": 2},
    "profile": False,
}

_FLOAT_RE = re.compile(
    """^(?:[-+]?[0-9][0-9_]*\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+
        |\\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\\.(?:inf|Inf|INF)
        |\\.(?:nan|NaN|NAN))$""",
    re.X,
)


def _read_yaml(path: str) -> Dict[str, Any]:
    import yaml

    class _Loader(yaml.SafeLoader):
        """SafeLoader with a YAML-1.2-style float resolver (1e-3 is a float)."""

    _Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float", _FLOAT_RE, list("-+0123456789.")
    )
    with open(path, "r", encoding="utf-8") as fin:
        out = yaml.load(fin.read(), Loader=_Loader)
    return out or {}


def _resolve_include(include: str, base_dir: str, search_dirs) -> str:
    cands = [os.path.join(base_dir, include)]
    cands += [os.path.join(d, include) for d in search_dirs]
    cands.append(include)
    for c in cands:
        if os.path.isfile(c):
            return os.path.abspath(c)
    raise FileNotFoundError(f"config include '{include}' not found; searched {cands}")


def _load_with_includes(path: str, search_dirs, _seen=None) -> Dict[str, Any]:
    path = os.path.abspath(path)
    _seen = set() if _seen is None else _seen
    if path in _seen:
        raise ValueError(f"config include cycle at {path}")
    _seen = _seen | {path}

    file_dict = _read_yaml(path)
    merged: Dict[str, Any] = {}
    base_dir = os.path.dirname(path)
    for include in file_dict.get("includes", []) or []:
        inc_path = _resolve_include(include, base_dir, search_dirs)
        merged.update(_load_with_includes(inc_path, search_dirs, _seen))
    merged.update({k: v for k, v in file_dict.items() if k != "includes"})
    return merged


class Config:
    """Defaults < user config file < overrides."""

    def __init__(
        self,
        config_file: Optional[str] = None,
        overrides: Optional[Dict[str, Any]] = None,
        search_dirs: Optional[list] = None,
    ):
        self.config_file = config_file
        self.search_dirs = list(search_dirs or [])
        if config_file:
            self.search_dirs.append(os.path.dirname(os.path.abspath(config_file)))
        self.search_dirs += [
            os.path.join(os.getcwd(), "config"),
            os.path.join(os.getcwd(), "configs"),
            REPO_CONFIGS,
        ]
        self.default_dict = copy.deepcopy(DEFAULTS)
        self.file_dict = (
            _load_with_includes(config_file, self.search_dirs) if config_file else {}
        )
        self.console_dict = dict(overrides or {})
        self.config_dict: Dict[str, Any] = {}
        for d in (self.default_dict, self.file_dict, self.console_dict):
            self.config_dict.update(copy.deepcopy(d))

    def get_config_dict(self) -> Dict[str, Any]:
        return self.config_dict

