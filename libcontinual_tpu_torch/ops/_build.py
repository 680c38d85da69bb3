"""Build and load the port's CUDA kernels.

``csrc/attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The library is built
at its first use (never at import), into ``build/libcontinual_tpu_torch/``
under the repository root, and its file name carries a hash of the source,
of every shared header in ``csrc/`` (``*.cuh``) and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused. :func:`lib` gives
the library with the argument types of every exported function set.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_PKG_DIR)), "build", "libcontinual_tpu_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIBRARY = "attention"

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: argument types of every function ``attention.cu`` exports; all return an int
SIGNATURES = {
    "lct_qkv_max_seq": [],
    "lct_qkv_fwd": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    "lct_qkv_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "lct_pqkv_max_keys": [],
    "lct_pqkv_fwd": [_P, _P, _P, _LL, _LL, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "lct_pqkv_bwd": [_P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "lct_mqkv_max_seq": [],
    "lct_mqkv_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "lct_mqkv_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str = LIBRARY) -> str:
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


def lib() -> ctypes.CDLL:
    """The attention library, built first if needed, its functions typed by
    :data:`SIGNATURES`."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = library_path()
            if not os.path.exists(out):
                log = _compile(LIBRARY, out)
                with open(out + ".ptxas.txt", "w") as f:
                    f.write(log)
            loaded = ctypes.CDLL(out)
            for fn, argtypes in SIGNATURES.items():
                getattr(loaded, fn).argtypes = argtypes
                getattr(loaded, fn).restype = ctypes.c_int
            _LIB = loaded
        return _LIB
