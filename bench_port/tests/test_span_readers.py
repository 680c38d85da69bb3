"""The readers of the program's spans (``bench_port/spans.py``, the
``transforms.device_pct``, ``step.boundary_idle_pct`` and
``step.host_syncs`` files of ``metrics/``) against hand-built recording
periods with known device times and sync counts, and on the tiny traced run
of the CPU, where they find no device times."""

import json
import os

import pytest

from bench_port import run
from bench_port.run import load_module
from libcontinual_tpu_torch.utils.trace import TRACER
import tiny

SEED = 2 ** 31 + 77
NAMES = ("transforms.device_pct", "step.boundary_idle_pct", "step.host_syncs")


def _reader(name):
    return load_module(os.path.join(tiny.BENCH, "metrics", f"{name}.py"), f"reader_{name}")


class _Period:
    def __init__(self, rows):
        self._rows = rows

    def rows(self):
        return self._rows


def _period(steps):
    """A period of steps, each ``(start, end, augment ms, syncs)``."""
    return _Period(_rows(steps))


def _rows(steps):
    """Rows of a period: each step ``(start, end, augment ms, syncs)`` on the
    device's clock, with its ``step.augment`` child."""
    rows, nid = [], 0
    for i, (start, end, aug, syncs) in enumerate(steps):
        nid += 1
        rows.append({"name": "trainer.step", "id": nid, "parent": None, "step": i,
                     "device_start_ms": start, "device_end_ms": end, "device_ms": end - start,
                     "syncs": syncs})
        nid += 1
        rows.append({"name": "step.augment", "id": nid, "parent": nid - 1, "step": i,
                     "device_start_ms": start, "device_end_ms": start + aug, "device_ms": aug,
                     "syncs": 0})
    return rows


# step 0 starts on a synchronised device and is left out; steps 1-4: 10 ms
# each, 2, 0, 1 ms idle before steps 2, 3 and 4
STEPS = [(0.0, 3.0, 1.0, 9), (5.0, 15.0, 0.1, 1), (17.0, 27.0, 0.2, 0),
         (27.0, 37.0, 0.3, 2), (38.0, 48.0, 0.4, 1)]


@pytest.fixture
def periods(monkeypatch):
    monkeypatch.setattr(TRACER, "periods", [])
    return TRACER.periods


def test_the_readers_on_a_hand_built_period(periods):
    periods.append(_period(STEPS))
    periods.append(_period([(0.0, 1.0, 1.0, 50)] * 4))  # not the first period: not read
    # median of 0.1/10, 0.2/10, 0.3/10, 0.4/10
    assert _reader("transforms.device_pct").read({}) == pytest.approx(2.5)
    # (2 + 0 + 1) ms idle over 38 - 5 ms from step 1's start to step 4's
    assert _reader("step.boundary_idle_pct").read({}) == pytest.approx(100.0 * 3.0 / 33.0)
    assert _reader("step.host_syncs").read({}) == 1.0  # median of 1, 0, 2, 1


def test_the_readers_find_nothing_without_device_times_or_steps(periods):
    assert all(_reader(n).read({}) is None for n in NAMES)  # no period
    rows = _rows(STEPS)
    for r in rows:
        r["device_start_ms"] = r["device_end_ms"] = r["device_ms"] = None
    periods.append(_Period(rows))
    assert all(_reader(n).read({}) is None for n in NAMES)
    periods[0] = _period(STEPS[:1])  # the first step alone is left out
    assert all(_reader(n).read({}) is None for n in NAMES)


def test_the_readers_give_none_on_the_tiny_traced_run(periods, tmp_path, capsys):
    bench_dir, bench = tiny.bench_tree(str(tmp_path))
    argv = ["--workload", "l2p_vit_b16.tiny", "--seed", str(SEED), "--seconds", "0.2",
            "--trace", "1"]
    assert run.main(argv, device="cpu", bench_dir=bench_dir, bench=bench) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the traced run's sub-windows ran under the profiler: the spans were recorded
    names = {r["name"] for r in periods[0].rows()}
    assert {"trainer.step", "step.augment", "step.forward"} <= names
    assert not set(NAMES) & set(line["metrics"])
    assert line["correct"], line["checks"]
