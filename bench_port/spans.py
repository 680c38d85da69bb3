"""Reading the port's own spans (``libcontinual_tpu_torch/utils/trace.py``):
the per-layer metrics that the program's ``trainer.step`` spans and their
children give, on the device's clock.

Each reader takes the tracer's first recording period. In a traced run that
is its first, device-only sub-window (A), which runs under a profiler, so
the tracer records its spans. The period's first step starts on a
synchronised device and is left out. Every function returns None where
there is nothing to read: a program without the tracer, no period, too few
steps, or no device times (the CPU).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def first_period_rows() -> Optional[List[Dict]]:
    """The rows (``Period.rows()``) of the tracer's first recording period,
    or None."""
    try:
        from libcontinual_tpu_torch.utils.trace import TRACER
    except ImportError:  # a program without the tracer
        return None
    return TRACER.periods[0].rows() if TRACER.periods else None


def _steps(rows: Optional[List[Dict]]) -> List[Dict]:
    """The period's ``trainer.step`` rows after its first, if they all have
    device times."""
    steps = [r for r in rows or [] if r["name"] == "trainer.step"][1:]
    if any(r.get("device_start_ms") is None for r in steps):
        return []
    return steps


def transforms_device_pct(rows: Optional[List[Dict]]) -> Optional[float]:
    """The median over steps of the device time of ``step.augment`` over
    that of its ``trainer.step``, in per cent."""
    steps = _steps(rows)
    augment = {r["parent"]: r for r in rows or [] if r["name"] == "step.augment"}
    shares = [100.0 * augment[s["id"]]["device_ms"] / s["device_ms"]
              for s in steps if s["id"] in augment and s["device_ms"] > 0]
    return statistics.median(shares) if shares else None


def boundary_idle_pct(rows: Optional[List[Dict]]) -> Optional[float]:
    """The device time from each step's end to the next step's start, summed,
    over the device time from each step's start to the next one's, in per
    cent: the idle the host leaves between steps."""
    steps = _steps(rows)
    pairs = list(zip(steps, steps[1:]))
    span = sum(b["device_start_ms"] - a["device_start_ms"] for a, b in pairs)
    if not pairs or span <= 0:
        return None
    idle = sum(max(0.0, b["device_start_ms"] - a["device_end_ms"]) for a, b in pairs)
    return 100.0 * idle / span


def host_syncs(rows: Optional[List[Dict]]) -> Optional[float]:
    """The median over steps of the synchronising CUDA operations counted in
    ``trainer.step``."""
    steps = _steps(rows)
    return float(statistics.median(r["syncs"] for r in steps)) if steps else None
