"""Explicit name -> factory registries for backbones, methods, datasets and buffers
(the same pattern and names as ``libcontinual_tpu/registry.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str | None = None, aliases: tuple = ()):
        def deco(fn):
            key = name or fn.__name__
            for k in (key, *aliases):
                if k in self._entries:
                    raise KeyError(f"duplicate {self.kind} registry entry: {k}")
                self._entries[k] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} '{name}'. Known: {known}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)


BACKBONES = Registry("backbone")
METHODS = Registry("method")
DATASETS = Registry("dataset")
BUFFERS = Registry("buffer")
