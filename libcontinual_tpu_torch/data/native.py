"""Host-side shuffles, row gathers and row concatenations, through the
repository's C++ host data engine (``native/libhostdata.so``, built by
``make -C native``) when it is built, and through an identical Python mirror
otherwise, so a seeded run draws the same batch order as
``libcontinual_tpu/data/native.py``."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

SO_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libhostdata.so",
)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.path.exists(SO_PATH):
        try:
            lib = ctypes.CDLL(SO_PATH)
        except OSError:
            return None
        lib.lct_gather_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.lct_gather_u8.restype = None
        lib.lct_shuffled_indices.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.lct_shuffled_indices.restype = None
        lib.lct_concat_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.lct_concat_u8.restype = None
        _LIB = lib
    return _LIB


def gather_rows(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``out[i] = src[indices[i]]``; the engine's threaded copy for large
    uint8 gathers, numpy otherwise."""
    lib = _lib()
    row_bytes = int(np.prod(src.shape[1:])) if src.ndim > 1 else 1
    small = len(indices) * row_bytes < (1 << 20)
    if lib is None or small or src.dtype != np.uint8 or not src.flags.c_contiguous:
        return src[indices]
    idx = np.ascontiguousarray(indices, np.int64)
    n = src.shape[0]
    idx = np.where(idx < 0, idx + n, idx)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"gather_rows: index out of range for {n} rows")
    out = np.empty((len(idx),) + src.shape[1:], np.uint8)
    lib.lct_gather_u8(src.ctypes.data, idx.ctypes.data, out.ctypes.data, len(idx), row_bytes)
    return out


def concat_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a`` then ``b`` along the rows; the engine's copy for uint8 blocks
    of equal row shape, numpy otherwise."""
    lib = _lib()
    if (
        lib is None
        or a.dtype != np.uint8
        or b.dtype != np.uint8
        or a.shape[1:] != b.shape[1:]
        or not (a.flags.c_contiguous and b.flags.c_contiguous)
    ):
        return np.concatenate([a, b])
    out = np.empty((len(a) + len(b),) + a.shape[1:], np.uint8)
    row_bytes = int(np.prod(a.shape[1:]))
    lib.lct_concat_u8(a.ctypes.data, len(a), b.ctypes.data, len(b), out.ctypes.data, row_bytes)
    return out


def _xorshift_permutation(n: int, seed: int) -> np.ndarray:
    """Python mirror of ``lct_shuffled_indices`` in ``native/host_data.cpp``:
    splitmix64 seed mix + xorshift64* Fisher-Yates."""
    mask = (1 << 64) - 1
    s = (seed + 0x9E3779B97F4A7C15) & mask
    s = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) & mask
    s = ((s ^ (s >> 27)) * 0x94D049BB133111EB) & mask
    s ^= s >> 31
    if not s:
        s = 0x9E3779B97F4A7C15
    out = list(range(n))
    for i in range(n - 1, 0, -1):
        s ^= s >> 12
        s = (s ^ (s << 25)) & mask
        s ^= s >> 27
        j = ((s * 0x2545F4914F6CDD1D) & mask) % (i + 1)
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, np.int64)


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    lib = _lib()
    if lib is None:
        return _xorshift_permutation(n, seed)
    out = np.empty((n,), np.int64)
    lib.lct_shuffled_indices(out.ctypes.data, n, np.uint64(seed))
    return out
