"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library is built
at its first use (never at import), into ``build/libcontinual_tpu_torch/``
under the repository root, and its file name carries a hash of the source,
of every shared header in ``csrc/`` (``*.cuh``) and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused. Two libraries may
build at once, each under its own lock.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_PKG_DIR)), "build", "libcontinual_tpu_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _compile(name: str, out: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return proc.stderr  # -Xptxas -v: registers, shared memory and spills


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not os.path.exists(out):
            log = _compile(name, out)
            with open(out + ".ptxas.txt", "w") as f:
                f.write(log)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
        return lib
