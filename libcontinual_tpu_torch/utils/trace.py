"""Spans and counters of the port's trainer and step, on the device trace's
clock.

One process-wide tracer, :data:`TRACER`. A span is a named, nested interval
of the program::

    with TRACER.span("trainer.step", step=s):
        ...

It holds its name, its id, its parent's id and the run's ids (``task``,
``epoch``, ``step``; a span that names none takes its parent's), its host
start and end (``time.perf_counter_ns``), on CUDA a device start and end (a
timing ``torch.cuda.Event`` recorded on the current stream at each side,
resolved to milliseconds without waiting once a few thousand have
completed, and the rest when the spans are read, so nothing waits on the hot
path), and two counters, inclusive of its children: ``syncs``, the
synchronising CUDA operations run inside it, and ``launches``, the
``(kind, shape)`` of each attention kernel launched inside it (the wrappers
of ``ops/`` call :meth:`Tracer.launch`; the period keeps each launch once,
with its innermost span).

Recording is on while the run's config sets ``profile: true`` (the trainer
calls :meth:`Tracer.begin` and :meth:`Tracer.end`) or while a
``torch.profiler`` records in the thread when a span opens. Spans are
grouped by recording period: one for a ``profile: true`` run, one per
profiler session (it ends when a span closes, with no other open, or
opens after the profiler stopped). Off, a span costs a flag check and the
call, and allocates nothing.

While a profiler records, each span also opens
``torch.profiler.record_function(name)``, so it shows in the profiler's
Chrome trace as a ``user_annotation`` under its own name. Each period keeps
an anchor, a ``(perf_counter_ns, time_ns)`` pair taken together, that maps
a span's host times onto the trace's axis: ``ts * 1000 +
baseTimeNanoseconds`` is ``time.time_ns()`` (:meth:`Period.trace_us`).

A period records on CUDA from the first span that opens once CUDA is
initialised (a ``profile: true`` run begins before its trainer touches the
card). From then on the tracer sets ``torch.cuda.set_sync_debug_mode("warn")``
and counts, instead of printing, the warnings it raises; the previous mode
and warning handlers come back when the period ends.

Counters outside the spans' own (:meth:`Tracer.count`: the buffer's herding
iterations and exemplars kept, the images evaluated) belong to the
innermost open span. :meth:`Period.rows` reads a period: each span's host
and device start, end, duration and self time (its duration less what its
children cover) with its counters; :meth:`Period.export` writes a period
through a ``Logger``'s ``events.jsonl`` as records of kind ``span`` and
``counter``.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
#: the text of the warning ``set_sync_debug_mode("warn")`` raises
SYNC_WARNING = "called a synchronizing CUDA operation"
#: closed spans whose device times wait before those that completed are resolved
RESOLVE_AT = 4096


class _Off:
    """The span of a tracer that is not recording: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded interval (see the module's docstring)."""

    __slots__ = ("name", "id", "parent", "task", "epoch", "step", "t0", "t1", "ev0", "ev1",
                 "d0", "d1", "syncs", "_rf", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional["Span"],
                 task, epoch, step):
        self._tracer = tracer
        self.name = name
        self.parent = parent.id if parent is not None else None
        self.task = task if task is not None or parent is None else parent.task
        self.epoch = epoch if epoch is not None or parent is None else parent.epoch
        self.step = step if step is not None or parent is None else parent.step
        self.id = 0
        self.t0 = self.t1 = None
        self.ev0 = self.ev1 = None
        #: the device start and end, ms from the period's first event, once resolved
        self.d0 = self.d1 = None
        self.syncs = 0
        self._rf = None

    def __enter__(self):
        self._tracer._open(self)
        return self

    def __exit__(self, *exc):
        self._tracer._close(self)
        return False


class Period:
    """The spans and counters of one recording period."""

    def __init__(self, index: int, kind: str):
        self.index = index
        #: "profile" (a ``profile: true`` run) or "profiler" (a profiler session)
        self.kind = kind
        #: whether it records on CUDA (from its first span after CUDA's start)
        self.cuda = False
        #: (perf_counter_ns, time_ns) taken together
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.spans: List[Span] = []
        #: (name, value, span id, labels)
        self.counters: List[Tuple[str, float, int, Dict[str, Any]]] = []
        #: (innermost span id, kind, shape) of each attention launch, in order
        self.launches: List[Tuple[int, str, Tuple[int, ...]]] = []
        self.ended = False
        self._rows: Optional[List[Dict[str, Any]]] = None
        self._saved = None
        #: the first device event, from which device times are read
        self._ref = None
        #: closed spans whose device times are not resolved yet
        self._pending: List[Span] = []

    def trace_us(self, perf_ns: int, base_time_ns: int) -> float:
        """The host time ``perf_ns`` (a ``perf_counter_ns()`` reading) on the
        axis of a Chrome trace whose ``baseTimeNanoseconds`` is
        ``base_time_ns``."""
        return (self.anchor[1] + (perf_ns - self.anchor[0]) - base_time_ns) / 1000.0

    def _resolve(self, wait: bool) -> None:
        """Device times of the pending spans: those whose events have
        completed, or, with ``wait``, all of them once the device is done."""
        if wait:
            torch.cuda.synchronize()
        elif not self._ref.query():
            return
        left = []
        for s in self._pending:
            if wait or (s.ev0.query() and s.ev1.query()):
                s.d0, s.d1 = self._ref.elapsed_time(s.ev0), self._ref.elapsed_time(s.ev1)
                s.ev0 = s.ev1 = None
            else:
                left.append(s)
        self._pending = left

    def rows(self) -> List[Dict[str, Any]]:
        """The closed spans in the order they opened, each a dict: ``name``,
        ``id``, ``parent``, ``task``, ``epoch``, ``step``; host
        ``host_start_ms`` and ``host_end_ms`` (from the anchor),
        ``host_ms``, ``host_self_ms``; on CUDA ``device_start_ms`` and
        ``device_end_ms`` (from the period's first device event),
        ``device_ms``, ``device_self_ms``, else None; ``syncs`` and
        ``launches`` (in launch order). The device times left are resolved
        here: the call waits for the device."""
        if self._rows is not None:
            return self._rows
        if self._pending:
            self._resolve(wait=True)
        rows = []
        by_id = {}
        for s in self.spans:
            if s.t1 is None:
                continue
            row = {"name": s.name, "id": s.id, "parent": s.parent, "task": s.task,
                   "epoch": s.epoch, "step": s.step,
                   "host_start_ms": (s.t0 - self.anchor[0]) * 1e-6,
                   "host_end_ms": (s.t1 - self.anchor[0]) * 1e-6,
                   "device_start_ms": s.d0, "device_end_ms": s.d1,
                   "syncs": s.syncs, "launches": []}
            rows.append(row)
            by_id[s.id] = row
        parent = {s.id: s.parent for s in self.spans}
        for sid, kind, shape in self.launches:  # a launch joins its span and its ancestors
            while sid is not None:
                if sid in by_id:
                    by_id[sid]["launches"].append((kind, shape))
                sid = parent.get(sid)
        _self_times(rows, "host")
        _self_times(rows, "device")
        if self.ended:
            self._rows = rows
        return rows

    def counter_rows(self) -> List[Dict[str, Any]]:
        """The counters, each a dict: ``name``, ``value``, ``span`` (the
        innermost open span's id) and its labels."""
        return [{"name": n, "value": v, "span": sid, **labels}
                for n, v, sid, labels in self.counters]

    def export(self, log) -> None:
        """Write the period through ``log.event``: one ``span`` record a span
        (its row, ``launches`` as a count per kind) and one ``counter``
        record a counter, each with the period's index and kind."""
        head = {"period": self.index, "period_kind": self.kind}
        for row in self.rows():
            kinds: Dict[str, int] = {}
            for kind, _ in row["launches"]:
                kinds[kind] = kinds.get(kind, 0) + 1
            log.event("span", **head, **dict(row, launches=kinds))
        for row in self.counter_rows():
            log.event("counter", **head, **row)


def _self_times(rows: List[Dict[str, Any]], side: str) -> None:
    """``<side>_ms`` and ``<side>_self_ms`` of each row: its duration, and
    its duration less the union of its children's intervals (clipped to
    it)."""
    lo, hi = f"{side}_start_ms", f"{side}_end_ms"
    children: Dict[int, List[Tuple[float, float]]] = {}
    for r in rows:
        if r["parent"] is not None and r[lo] is not None:
            children.setdefault(r["parent"], []).append((r[lo], r[hi]))
    for r in rows:
        if r[lo] is None:
            r[f"{side}_ms"] = r[f"{side}_self_ms"] = None
            continue
        dur = r[hi] - r[lo]
        r[f"{side}_ms"] = dur
        r[f"{side}_self_ms"] = dur - _covered(children.get(r["id"], []), r[lo], r[hi])


def _covered(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


class Tracer:
    """The process's spans and counters (see the module's docstring)."""

    def __init__(self):
        self.periods: List[Period] = []
        self._period: Optional[Period] = None
        self._stack: List[Span] = []
        self._forced = 0
        self._next_id = 0

    # ------------------------------------------------------------ recording

    def span(self, name: str, task=None, epoch=None, step=None):
        """A context manager that records the interval it covers while the
        tracer records, and does nothing otherwise."""
        if not self._forced and not _profiler_enabled():
            if self._period is not None and not self._stack:
                self._end_period()
            return _OFF
        return Span(self, name, self._stack[-1] if self._stack else None, task, epoch, step)

    def _open(self, s: Span) -> None:
        if self._period is None:
            self._begin_period("profiler")
        period = self._period
        self._next_id += 1
        s.id = self._next_id
        # the annotation is made first (an allocation, which can run the
        # garbage collector), then the host start is read, then the annotation
        # opens, whose first call in a profiler session can take a millisecond
        # after it has read its own start
        rf = torch.profiler.record_function(s.name) if _profiler_enabled() else None
        s.t0 = time.perf_counter_ns()
        if rf is not None:
            rf.__enter__()
            s._rf = rf
        if not period.cuda and torch.cuda.is_initialized():
            self._record_cuda(period)
        if period.cuda:
            s.ev0 = torch.cuda.Event(enable_timing=True)
            s.ev1 = torch.cuda.Event(enable_timing=True)
            s.ev0.record()
            if period._ref is None:
                period._ref = s.ev0
        self._stack.append(s)
        period.spans.append(s)

    def _close(self, s: Span) -> None:
        s.t1 = time.perf_counter_ns()
        if s.ev1 is not None:
            s.ev1.record()
            pending = self._period._pending
            pending.append(s)
            if len(pending) >= RESOLVE_AT:
                self._period._resolve(wait=False)
        if s._rf is not None:
            s._rf.__exit__(None, None, None)
            s._rf = None
        while self._stack:
            if self._stack.pop() is s:
                break
        if not self._stack and not self._forced and not _profiler_enabled():
            self._end_period()

    def launch(self, kind: str, shape: Tuple[int, ...]) -> None:
        """An attention kernel launch: ``(kind, shape)`` of the innermost open
        span (and so of its parents)."""
        if self._stack:
            self._period.launches.append((self._stack[-1].id, kind, shape))

    def count(self, name: str, value: float = 1, **labels: Any) -> None:
        """A counter of the innermost open span (nothing when none is
        recording)."""
        if self._stack:
            self._period.counters.append((name, value, self._stack[-1].id, labels))

    # -------------------------------------------------------------- periods

    def _begin_period(self, kind: str) -> Period:
        period = Period(len(self.periods), kind)
        self.periods.append(period)
        self._period = period
        return period

    def _record_cuda(self, period: Period) -> None:
        """From now on ``period`` records device times and counts syncs."""
        period.cuda = True
        catcher = warnings.catch_warnings()
        catcher.__enter__()
        period._saved = (catcher, torch.cuda.get_sync_debug_mode())
        show = warnings.showwarning

        def on_warning(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                for s in self._stack:
                    s.syncs += 1
            else:
                show(message, category, filename, lineno, file, line)

        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")

    def _end_period(self) -> None:
        period, self._period = self._period, None
        if period is None:
            return
        period.ended = True
        if period._saved is not None:
            catcher, mode = period._saved
            torch.cuda.set_sync_debug_mode(mode)
            catcher.__exit__(None, None, None)
            period._saved = None

    def begin(self) -> Period:
        """Record from now until :meth:`end`, whether or not a profiler
        records, in one period of kind ``"profile"`` (a ``profile: true``
        run). A period of a profiler session that is open and has no open
        span ends here."""
        if self._forced == 0 and self._period is not None and not self._stack:
            self._end_period()
        self._forced += 1
        return self._period if self._period is not None else self._begin_period("profile")

    def end(self) -> None:
        """Undo one :meth:`begin`; the last ends its period."""
        self._forced = max(0, self._forced - 1)
        if not self._forced and not self._stack:
            self._end_period()


#: the process's tracer
TRACER = Tracer()
