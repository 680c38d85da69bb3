"""Structured logging: console logger + optional ``train.log`` tee + JSONL
event log (the same surface as ``libcontinual_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional


class Logger:
    """Console logger + optional file tee + JSONL event log."""

    def __init__(self, save_dir: Optional[str] = None, name: str = "libcontinual_torch"):
        self._log = logging.getLogger(name)
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        if not self._log.handlers:
            h = logging.StreamHandler(sys.stdout)
            h.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
            self._log.addHandler(h)
        self._jsonl = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            # one run directory at a time: drop (and close) file handlers a
            # previous Trainer attached to this shared logger, or every line
            # from run N would also be appended to run N-1's train.log
            for old in [h for h in self._log.handlers
                        if isinstance(h, logging.FileHandler)]:
                self._log.removeHandler(old)
                old.close()
            fh = logging.FileHandler(os.path.join(save_dir, "train.log"))
            fh.setFormatter(
                logging.Formatter("[%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S")
            )
            self._log.addHandler(fh)
            self._jsonl = open(os.path.join(save_dir, "events.jsonl"), "a")

    def info(self, msg: str, *args):
        self._log.info(msg, *args)

    def event(self, kind: str, **fields: Any):
        if self._jsonl is not None:
            rec: Dict[str, Any] = {"ts": time.time(), "kind": kind}
            rec.update(fields)
            # json.dumps would emit the non-standard Infinity/NaN tokens
            # (e.g. ovr_frgt is inf for 2-task runs), breaking strict JSON
            # consumers of events.jsonl — record null instead
            self._jsonl.write(
                json.dumps(_definite(rec), default=_jsonable) + "\n"
            )
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _jsonable(x):
    try:
        v = float(x)
        return v if np_isfinite(v) else None
    except Exception:
        return str(x)


def np_isfinite(v: float) -> bool:
    return v == v and v not in (float("inf"), float("-inf"))


def _definite(v):
    """Replace non-finite floats with None, recursively."""
    if isinstance(v, float):
        return v if np_isfinite(v) else None
    if isinstance(v, dict):
        return {k: _definite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_definite(x) for x in v]
    return v


_DEFAULT: Optional[Logger] = None


def get_logger(save_dir: Optional[str] = None) -> Logger:
    global _DEFAULT
    if _DEFAULT is None or save_dir:
        if _DEFAULT is not None and save_dir:
            _DEFAULT.close()  # release the previous run's events.jsonl handle
        _DEFAULT = Logger(save_dir)
    return _DEFAULT
