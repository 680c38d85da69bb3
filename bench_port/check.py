"""The comparison that decides ``correct`` for a training cell.

Set-up runs the cell's first steps through the trainer; the plain reference
follows the first three from the same weights, batches, learning rates and
augmentation draws. Four numbers, each of the worst case:

* ``loss``: the largest relative gap of a step's loss, ``|L_p - L_r| / |L_r|``;
* ``grad``: the first gradient as the optimizer got it, read back from the
  program's optimizer state after one step; per leaf the gap of the norms,
  ``| |g_p| - |g_r| |``, over the larger of the reference leaf's norm and the
  median leaf's; the worst leaf;
* ``change``: the same of the parameters' change after three steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (below that a leaf moves by round-off alone under Adam);
* ``grad_head_diff``: the classifier head's first gradients (``head.*``)
  compared as tensors, the worst leaf's ``|g_p - g_r| / |g_r|``. The head's
  gradient depends on the forward features and the loss alone. Where the
  backbone's BatchNorms make every gradient below the head differ by tens of
  per cent under bf16 rounding while the norms agree (the ResNet cells), a
  norm's gap takes the control's rounding only at second order and no norm
  separates the control from the program; this does.

A cell's ``limits`` name the numbers it compares. A number that is not
finite fails; ``correct`` holds when every compared number is at or under
its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

#: a leaf counts in ``change`` when its reference gradient reaches this
#: share of the median leaf's
MOVING_LEAF = 1e-3


def first_grad(opt: torch.optim.Optimizer, param: torch.nn.Parameter,
               start: torch.Tensor) -> torch.Tensor:
    """The gradient the optimizer got at its first step, from its state
    after that step: Adam's first moment over (1 - beta1), SGD's momentum
    buffer; both less the coupled weight decay on the starting value. A leaf
    with no state got no gradient."""
    group = next(g for g in opt.param_groups if any(p is param for p in g["params"]))
    st = opt.state.get(param, {})
    wd = float(group.get("weight_decay", 0.0))
    if "exp_avg" in st:
        g = st["exp_avg"] / (1.0 - group["betas"][0])
    elif st.get("momentum_buffer") is not None:
        g = st["momentum_buffer"].clone()
    else:
        return torch.zeros_like(param)
    return g - wd * start.to(g.dtype) if wd else g


def _gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Per leaf: the gap of the norms over the larger of the reference
    leaf's norm and the median leaf's."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers; ``prog`` and ``ref`` hold ``losses`` (three floats),
    ``grad`` and ``change`` ({leaf: norm}) and, for ``grad_head_diff``,
    ``grad_vec`` ({leaf: first gradient})."""
    loss = max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    g_ref = ref["grad"]
    med_g = statistics.median(g_ref.values())
    grad = _gaps(prog["grad"], g_ref, list(g_ref))
    moving = [n for n in g_ref if g_ref[n] >= MOVING_LEAF * med_g]
    change = _gaps(prog["change"], ref["change"], moving)

    head = [n for n in g_ref if n.startswith("head.")]
    diff = math.nan
    if head and "grad_vec" in prog and "grad_vec" in ref:
        diff = max(float(torch.linalg.vector_norm((prog["grad_vec"][n] - ref["grad_vec"][n])
                                                  .double()))
                   / max(ref["grad"][n], 1e-30) for n in head)
    return {"loss": loss, "grad": max(grad.values()), "change": max(change.values()),
            "grad_head_diff": diff}


def worst_leaves(prog: Dict, ref: Dict, key: str, n: int = 5) -> List:
    """The ``n`` leaves of largest gap in ``key`` ("grad" or "change")."""
    gaps = _gaps(prog[key], ref[key], list(ref[key]))
    return sorted(([name, gap] for name, gap in gaps.items()), key=lambda x: -x[1])[:n]


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Dict]]:
    """(correct, [{name, value, limit}]) for the numbers a cell compares,
    the keys of its ``limits``."""
    rows = [{"name": n, "value": values[n], "limit": limits[n]} for n in limits]
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows)
    return ok, rows
