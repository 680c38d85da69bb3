"""``query.device_pct``: the frozen query pass's share of a training step's
device time, from the program's ``step.query`` span (inside
``step.forward``) and its ``trainer.step`` (moves ``train_img_per_s``): the
median over the first recording period's steps, read as
``transforms.device_pct`` reads ``step.augment`` (``bench_port/spans.py``).
None where the program has no ``step.query`` span."""

import statistics

from bench_port import spans


def share(rows):
    """The median over steps of the device time of the ``step.query`` spans
    under a ``trainer.step`` over that step's, in per cent."""
    steps = {r["id"]: r for r in spans._steps(rows)}
    parent = {r["id"]: r["parent"] for r in rows or []}
    query = {}
    for r in rows or []:
        if r["name"] != "step.query" or r.get("device_ms") is None:
            continue
        sid = r["parent"]
        while sid is not None and sid not in steps:
            sid = parent.get(sid)
        if sid is not None:
            query[sid] = query.get(sid, 0.0) + r["device_ms"]
    shares = [100.0 * query[sid] / s["device_ms"] for sid, s in steps.items()
              if sid in query and s["device_ms"] > 0]
    return statistics.median(shares) if shares else None


def read(t):
    return share(spans.first_period_rows())
