"""The port's spans and counters (``libcontinual_tpu_torch/utils/trace.py``)
on the CPU: the span tree of a 2-task ``profile: true`` run, that recording
changes nothing the run computes, that nothing records while tracing is off,
the spans as annotations of a ``torch.profiler`` trace on the anchor's
clock, the herding counters, the ``events.jsonl`` records and self times."""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.core.trainer import Trainer  # noqa: E402
from libcontinual_tpu_torch.utils import trace  # noqa: E402
from libcontinual_tpu_torch.utils.trace import TRACER  # noqa: E402
from test_torch_rehearsal_trainer import _config as rehearsal_config  # noqa: E402
from test_torch_trainer import OVERRIDES  # noqa: E402

#: (name, parent's name) of every span a run with validation records; the
#: step's children come from the base ``Method.train_step``, the query pass
#: and the prompt choice from L2P's ``forward_logits``, in training, in
#: evaluation and in the closing inference-rate probe, which no span holds (a
#: tuple: any of these parents)
TREE = {
    "trainer.build": None, "trainer.streams": "trainer.build", "method.build": "trainer.build",
    "method.init_state": "trainer.build",
    "trainer.task": None, "trainer.epoch": "trainer.task", "epoch.prepare": "trainer.epoch",
    "trainer.step": "trainer.epoch", "epoch.drain": "trainer.epoch",
    "step.batch": "trainer.step", "step.augment": "trainer.step", "step.forward": "trainer.step",
    "step.backward": "trainer.step", "step.optimizer": "trainer.step",
    "trainer.boundary": "trainer.task", "method.after_task": "trainer.boundary",
    "method.extra_phases": "trainer.boundary", "trainer.eval": "trainer.task",
    "step.query": ("step.forward", "trainer.eval", None),
    "step.prompts": ("step.forward", "trainer.eval", None),
}


def _cfg(**extra):
    return Config(overrides=dict(copy.deepcopy(OVERRIDES), **extra)).get_config_dict()


def _run(cfg):
    losses = []
    tr = Trainer(cfg, device="cpu")
    tr.epoch_hook = lambda t, e, s, step_losses: losses.append(np.asarray(step_losses))
    return tr, tr.train_loop(), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 2-task L2P run with ``profile`` off and on: (periods the off
    run added, the on run's period, its save path, both results)."""
    before = len(TRACER.periods)
    _, off, off_losses = _run(_cfg())
    added_off = TRACER.periods[before:]
    save = str(tmp_path_factory.mktemp("profiled"))
    _, on, on_losses = _run(_cfg(profile=True, save_path=save))
    return {"added_off": added_off, "period": TRACER.periods[-1], "save": save,
            "off": (off, off_losses), "on": (on, on_losses)}


def test_profile_run_gives_the_span_tree(runs):
    period = runs["period"]
    assert period.kind == "profile" and period.ended and not period.cuda
    rows = period.rows()
    by_id = {r["id"]: r for r in rows}
    assert {r["name"] for r in rows} == set(TREE)
    for r in rows:
        parent = by_id.get(r["parent"])
        allowed = TREE[r["name"]]
        assert (parent["name"] if parent else None) in (
            allowed if isinstance(allowed, tuple) else (allowed,)), r
        if parent is not None:  # nested within its parent on the host clock
            assert parent["host_start_ms"] <= r["host_start_ms"] <= r["host_end_ms"]
            assert r["host_end_ms"] <= parent["host_end_ms"]
            for key in ("task", "epoch", "step"):  # ids the span names none of are its parent's
                assert r[key] == parent[key] or parent[key] is None, (r, parent)
    steps = [r for r in rows if r["name"] == "trainer.step"]
    # 2 tasks x 2 epochs x 6 steps (96 images a task, batches of 16)
    assert [(r["task"], r["epoch"], r["step"]) for r in steps] == [
        (t, e, s) for t in range(2) for e in range(2) for s in range(6)]
    for st in steps:
        kids = [r["name"] for r in rows if r["parent"] == st["id"]]
        assert kids == ["step.batch", "step.augment", "step.forward", "step.backward",
                        "step.optimizer"]
        assert all(by_id[r["id"]]["step"] == st["step"] for r in rows if r["parent"] == st["id"])
    tasks = [r for r in rows if r["name"] == "trainer.task"]
    assert [r["task"] for r in tasks] == [0, 1]
    assert [r["task"] for r in rows if r["name"] == "trainer.eval"] == [0, 1]
    assert all(r["device_ms"] is None and r["syncs"] == 0 for r in rows)


def test_profile_leaves_the_run_unchanged(runs):
    (off, off_losses), (on, on_losses) = runs["off"], runs["on"]
    assert len(off_losses) == len(on_losses) == 4
    for a, b in zip(off_losses, on_losses):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(off["acc_table"], on["acc_table"])


def test_nothing_records_while_tracing_is_off(runs):
    assert runs["added_off"] == []
    assert TRACER.span("trainer.step") is TRACER.span("step.batch")  # the one no-op
    with TRACER.span("trainer.step"):
        TRACER.launch("qkv_fwd", (1, 2, 3, 4))
        TRACER.count("eval.images", 5)
    assert TRACER.periods[-1] is runs["period"]


def test_events_hold_the_span_and_counter_records(runs):
    with open(os.path.join(runs["save"], "events.jsonl"), encoding="utf-8") as fin:
        events = [json.loads(line) for line in fin]
    spans = [e for e in events if e["kind"] == "span"]
    counters = [e for e in events if e["kind"] == "counter"]
    rows = runs["period"].rows()
    assert [(e["name"], e["id"], e["parent"]) for e in spans] == [
        (r["name"], r["id"], r["parent"]) for r in rows]
    assert all(e["period_kind"] == "profile" and e["host_ms"] >= e["host_self_ms"] >= 0
               for e in spans)
    # the evaluations after tasks 0 and 1: 24 test images a class, 4 classes a task
    evals = [(e["name"], e["value"]) for e in counters]
    assert evals == [("eval.images", 96)] * 3
    # the Chrome trace of task 0's epoch 1 carries the spans under their names
    with open(os.path.join(runs["save"], "trace_task0_epoch1.json"), encoding="utf-8") as fin:
        doc = json.load(fin)
    names = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"trainer.epoch", "epoch.prepare", "trainer.step", "step.forward",
            "epoch.drain"} <= names


def test_spans_are_annotations_of_the_profiler_trace(tmp_path):
    tr = Trainer(_cfg(task_num=1, epoch=1), device="cpu")
    before = len(TRACER.periods)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_loop()
    (period,) = TRACER.periods[before:]
    assert period.kind == "profiler" and not period.ended
    with TRACER.span("after"):  # the first span after the session ends its period
        pass
    assert period.ended and TRACER.periods[-1] is period
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as fin:
        doc = json.load(fin)
    base = int(doc["baseTimeNanoseconds"])
    notes = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation":
            notes.setdefault(e["name"], []).append(float(e["ts"]))
    rows = period.rows()
    assert {r["name"] for r in rows} == set(TREE) - {"trainer.build", "trainer.streams",
                                                     "method.build", "method.init_state"}
    for s in period.spans:
        ts = period.trace_us(s.t0, base)
        assert min(abs(ts - t) for t in notes[s.name]) < 1000.0, s.name  # within 1 ms


def test_herding_counters(tmp_path):
    """iCaRL keeps ``per_cls`` of a class's n images and herds over all n:
    10 images a class, a buffer of 8 over 4 classes after task 0 and over 8
    after task 1."""
    cfg = Config(overrides=dict(rehearsal_config("ICarl"), profile=True,
                                save_path=str(tmp_path))).get_config_dict()
    Trainer(cfg, device="cpu").train_loop()
    period = TRACER.periods[-1]
    got = {}
    for c in period.counter_rows():
        if c["name"].startswith("buffer."):
            got[(c["name"], c["cls"])] = c["value"]
    for cls in range(8):
        assert got[("buffer.herding_iters", cls)] == 10
        assert got[("buffer.exemplars_kept", cls)] == (2 if cls < 4 else 1)
    spans = {r["id"]: r["name"] for r in period.rows()}
    assert {spans[c["span"]] for c in period.counter_rows()
            if c["name"].startswith("buffer.")} == {"buffer.update"}
    assert {r["name"] for r in period.rows()} >= {"buffer.update"}
    with open(os.path.join(str(tmp_path), "events.jsonl"), encoding="utf-8") as fin:
        kinds = [json.loads(line)["kind"] for line in fin]
    assert kinds.count("counter") == len(period.counters) > 0


def test_self_time_is_duration_less_the_childrens_union(runs):
    rows = [
        {"name": "p", "id": 1, "parent": None, "host_start_ms": 0.0, "host_end_ms": 10.0,
         "device_start_ms": None, "device_end_ms": None},
        {"name": "a", "id": 2, "parent": 1, "host_start_ms": 1.0, "host_end_ms": 4.0,
         "device_start_ms": None, "device_end_ms": None},
        {"name": "b", "id": 3, "parent": 1, "host_start_ms": 3.0, "host_end_ms": 6.0,
         "device_start_ms": None, "device_end_ms": None},  # overlaps a: 1-6 covered
        {"name": "c", "id": 4, "parent": 1, "host_start_ms": 9.0, "host_end_ms": 12.0,
         "device_start_ms": None, "device_end_ms": None},  # clipped to 9-10
        {"name": "d", "id": 5, "parent": 2, "host_start_ms": 2.0, "host_end_ms": 3.0,
         "device_start_ms": None, "device_end_ms": None},  # a grandchild: not p's
    ]
    trace._self_times(rows, "host")
    trace._self_times(rows, "device")
    assert [r["host_ms"] for r in rows] == [10.0, 3.0, 3.0, 3.0, 1.0]
    assert [r["host_self_ms"] for r in rows] == [10.0 - 6.0, 2.0, 3.0, 3.0, 1.0]
    assert all(r["device_ms"] is None and r["device_self_ms"] is None for r in rows)
    # and in the run: a step's self time is its duration less its five children
    got = runs["period"].rows()
    for st in (r for r in got if r["name"] == "trainer.step"):
        kids = [r for r in got if r["parent"] == st["id"]]
        assert st["host_self_ms"] == pytest.approx(
            st["host_ms"] - sum(k["host_ms"] for k in kids), abs=1e-9)


def test_launches_and_counters_join_the_open_spans():
    TRACER.begin()
    try:
        with TRACER.span("trainer.step", task=3, epoch=1, step=2) as outer:
            with TRACER.span("step.forward") as inner:
                TRACER.launch("qkv_fwd", (2, 5, 12, 3))
                TRACER.count("eval.images", 7, cls=1)
            TRACER.launch("qkv_bwd", (2, 5, 12, 3))
    finally:
        TRACER.end()
    period = TRACER.periods[-1]
    assert period.ended and TRACER.span("x") is TRACER.span("y")
    # each launch is kept once, with its innermost span; a row's are its own and its children's
    assert period.launches == [(inner.id, "qkv_fwd", (2, 5, 12, 3)),
                               (outer.id, "qkv_bwd", (2, 5, 12, 3))]
    launches = {r["id"]: r["launches"] for r in period.rows()}
    assert launches[outer.id] == [("qkv_fwd", (2, 5, 12, 3)), ("qkv_bwd", (2, 5, 12, 3))]
    assert launches[inner.id] == [("qkv_fwd", (2, 5, 12, 3))]
    assert (inner.task, inner.epoch, inner.step, inner.parent) == (3, 1, 2, outer.id)
    assert period.counter_rows() == [{"name": "eval.images", "value": 7, "span": inner.id,
                                      "cls": 1}]
