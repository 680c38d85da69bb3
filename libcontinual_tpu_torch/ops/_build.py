"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` of :data:`LIBRARIES` is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``: ``attention.cu`` (the packed-qkv, prefix and masked attention
kernels, and the generic attention forward), ``conv.cu`` (the 3x3 convolution
and its weight gradient) and ``layer_norm.cu`` (LayerNorm, forward and
backward). A
library is built at its first use (never at import), into
``build/libcontinual_tpu_torch/`` under the repository root, and its file
name carries a hash of the source, of every shared header in ``csrc/``
(``*.cuh``) and of the flags, so an edited source or header is rebuilt and an
unchanged one is reused. :func:`build` compiles several libraries at once,
one ``nvcc`` each, all started together. :func:`lib` gives a library with the
argument types of every function it exports set from :data:`SIGNATURES`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_PKG_DIR)), "build", "libcontinual_tpu_torch"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIBRARIES = ("attention", "conv", "layer_norm")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: argument types of every function each library exports; all return an int
SIGNATURES = {
    "attention": {
        "lct_qkv_fwd": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
        "lct_qkv_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "lct_pqkv_fwd": [_P, _P, _P, _LL, _LL, _P, _I, _I, _I, _I, _I, _I, _F, _P],
        "lct_pqkv_bwd": [_P, _P, _P, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _P],
        "lct_mqkv_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "lct_mqkv_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "lct_attn_max_head_dim": [],
        "lct_attn_onepass": [_I, _I, _I],
        "lct_attn_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_LL] * 9, _I, _I, _F, _P],
    },
    "conv": {
        "lct_conv3x3_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "lct_conv3x3_dw_slices": [_I, _I, _I, _I, _I],
        "lct_conv3x3_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "layer_norm": {
        "lct_ln_bwd_parts": [_I],
        "lct_ln_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        "lct_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


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


def _compile(names: Iterable[str]) -> None:
    """Compile the missing libraries of ``names``, one ``nvcc`` each, all at
    once; the ptxas report (registers, shared memory, spills) goes beside each
    library as ``.ptxas.txt``."""
    todo = [(n, library_path(n)) for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        with open(out + ".ptxas.txt", "w") as f:
            f.write(err)
    if failed:
        raise RuntimeError("\n".join(failed))


def _load(name: str) -> ctypes.CDLL:
    loaded = ctypes.CDLL(library_path(name))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(loaded, fn).argtypes = argtypes
        getattr(loaded, fn).restype = ctypes.c_int
    return loaded


def build(names: Iterable[str] = LIBRARIES) -> None:
    """Build (in parallel) and load every library of ``names``."""
    names = list(names)
    with _LOCK:
        _compile(n for n in names if n not in _LIBS)
        for n in names:
            if n not in _LIBS:
                _LIBS[n] = _load(n)


def lib(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if needed, its functions typed by
    :data:`SIGNATURES`."""
    if name not in _LIBS:
        build([name])
    return _LIBS[name]
