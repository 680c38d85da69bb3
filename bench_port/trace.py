"""Reading a traced sub-window: the device's kernel intervals from
``torch.profiler``, their union, the idle gaps and what the host did during
them, and the shapes of the attention launches.

The union of intervals, not their sum, gives the device's busy time:
kernels on different streams may overlap.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from bench_port import bounds

#: trace categories that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories that are the host's
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval], lo: float = float("-inf"),
          hi: float = float("inf")) -> List[Interval]:
    """The union of ``[start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``[lo, hi]`` that the disjoint sorted ``busy`` leaves
    uncovered."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def events_of(prof) -> List[Dict]:
    """The complete ("X") events of a finished profile, from its Chrome trace
    (written to the temporary directory and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_port_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, "r", encoding="utf-8") as fin:
            doc = json.load(fin)
    finally:
        os.remove(path)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in evs if e.get("ph") == "X" and "dur" in e and "ts" in e]


def summarize(events: List[Dict], top: int = 10) -> Dict:
    """Busy and window seconds, the kernels (name, seconds), the device
    operations that took most time, and the idle gaps of one sub-window.
    The window runs from the first event of any kind to the last one's end
    (the sub-window starts and ends on a device synchronisation)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {}
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev], lo, hi)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": [(e["name"], float(e["dur"]) * 1e-6) for e in dev if e.get("cat") == "kernel"],
        "device_ops": [[name[:160], sec] for name, sec in ops],
        "gaps": gaps(busy, lo, hi),
    }


def label_gaps(events: List[Dict], gap_list: Sequence[Interval], top: int = 10) -> List:
    """The ``top`` longest idle gaps, each named by the innermost host event
    (an aten op or a CUDA runtime call) running at its midpoint."""
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in HOST_CATS]
    out = []
    for s, e in sorted(gap_list, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        inside = [h for h in host if h[0] <= mid <= h[1]]
        name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "no host event"
        out.append([name[:160], (e - s) * 1e-6])
    return out


# ------------------------------------------------------ per-layer arithmetic
# Each reader in ``metrics/`` calls one of these on the traced run's record
# (``drivers/train.py``); None where the run has nothing to read.

#: the port's packed, prefix and masked attention kernels (ops/csrc/attention.cu)
ATTENTION_KERNELS = re.compile(r"\battn_(fwd|bwd_dq|bwd_dkdv)_kernel\b")


def kernels_a_step(t: Dict) -> Optional[float]:
    """CUDA kernels a step in the profiled sub-window (copies and sets not
    counted)."""
    return len(t["kernels"]) / t["steps"] if t.get("kernels") else None


def mfu(t: Dict) -> Optional[float]:
    """The whole step's share of the dense bf16 peak: model operations an
    image times the traced run's unprofiled images a second."""
    if not t.get("img_per_s") or not t.get("flops_per_image"):
        return None
    return 100.0 * t["flops_per_image"] * t["img_per_s"] / bounds.BF16_FLOP_PER_S


def attention_roofline(t: Dict) -> Optional[float]:
    """The sum of the recorded attention launches' bounds over the device
    time of the kernels they ran, in per cent."""
    launches = t.get("launches") or []
    seconds = sum(d for name, d in t.get("kernels", []) if ATTENTION_KERNELS.search(name))
    if not launches or seconds <= 0.0:
        return None
    return 100.0 * sum(bounds.launch_bound(kind, shape) for kind, shape in launches) / seconds


def idle_pct(t: Dict) -> Optional[float]:
    """The share of the sub-window's wall time in which no kernel, copy or
    set ran on the device."""
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def profiler(cpu: bool):
    """A ``torch.profiler.profile`` of the device (and of the host's ops with
    ``cpu``), to be started and stopped by the caller."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    return profile(activities=acts)


@contextlib.contextmanager
def record_launches(out: List):
    """Within it, each launch of a packed, prefix or masked attention wrapper
    appends ``(kind, shape)`` to ``out``: (B, S, D, heads), or (B, S, P, D,
    heads) for the prefix kernels. The wrappers run as before."""
    from libcontinual_tpu_torch.ops import attention as A
    from libcontinual_tpu_torch.ops import masked_attention as MA
    from libcontinual_tpu_torch.ops import prefix_attention as PA

    def packed(qkv, heads):
        return (qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, int(heads))

    def prefix(qkv, pk, heads):
        return (qkv.shape[0], qkv.shape[1], pk.shape[1], qkv.shape[2] // 3, int(heads))

    wrapped = [
        (A, "qkv_attention_cuda", "qkv_fwd", lambda a: packed(a[0], a[-1])),
        (A, "qkv_attention_bwd_cuda", "qkv_bwd", lambda a: packed(a[0], a[-1])),
        (PA, "prefix_attention_cuda", "pqkv_fwd", lambda a: prefix(a[0], a[1], a[-1])),
        (PA, "prefix_attention_bwd_cuda", "pqkv_bwd", lambda a: prefix(a[0], a[1], a[-1])),
        (MA, "masked_attention_cuda", "mqkv_fwd", lambda a: packed(a[0], a[-1])),
        (MA, "masked_attention_bwd_cuda", "mqkv_bwd", lambda a: packed(a[0], a[-1])),
    ]
    saved = [getattr(mod, attr) for mod, attr, _, _ in wrapped]

    def recording(fn, kind, shape_of):
        def call(*args):
            out.append((kind, shape_of(args)))
            return fn(*args)
        return call

    for (mod, attr, kind, shape_of), fn in zip(wrapped, saved):
        setattr(mod, attr, recording(fn, kind, shape_of))
    try:
        yield out
    finally:
        for (mod, attr, _, _), fn in zip(wrapped, saved):
            setattr(mod, attr, fn)
