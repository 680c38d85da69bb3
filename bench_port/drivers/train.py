"""The ``train`` driver: one task's training epochs through the port's
``Trainer``.

Set-up builds the trainer from the configuration and the benchmark's
arrays, brings it to the cell's task as ``Trainer.train_loop`` would (the
earlier tasks trained for the configuration's epochs, then ``after_task``,
the buffer update and the extra phases; then the cell's task's
``start_task``, ``before_task`` and ``reset_optimizer``), replaces the
weights by the benchmark's, seeds the augmentation generator, and runs the
task's first steps through ``Trainer._train_task``: the first three are
recorded for the check, the rest warm up. The window then runs the task's
epochs through ``Trainer._train_task``, one epoch a call, and ends at the
first epoch end after ``--seconds``, where the trainer synchronises.

A traced run adds two profiled sub-windows after the window, each inside an
epoch: the device alone over ``profile_steps`` steps (kernels, busy time,
attention launches), then the device and the host's ops over half as many
(what the host did in the idle gaps).
"""

from __future__ import annotations

import gc
import logging
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from bench_port import check, trace, traffic, weights

#: first steps the reference follows
CHECKED_STEPS = 3
#: steps of set-up through the epoch loop: the checked ones, then warm-up
WARM_STEPS = 5


class _Stop(Exception):
    """Ends ``Trainer._train_task`` early, after a step."""


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_trainer(config: Dict, arrays: Dict, device):
    """The port's ``Trainer`` over the benchmark's arrays: its ``build_stream``
    is replaced, while the trainer is built, by one that splits the given
    arrays into the configuration's tasks (``data/continual.py``)."""
    from libcontinual_tpu_torch.core import trainer as trainer_mod
    from libcontinual_tpu_torch.data.continual import ContinualStream

    def streams(cfg, mode, orig_to_new=None):
        images, labels = arrays[mode]
        stream = ContinualStream(images, labels, task_num=cfg["task_num"],
                                 init_cls_num=cfg["init_cls_num"],
                                 inc_cls_num=cfg["inc_cls_num"])
        n = stream.num_classes
        stream.class_names = [f"class_{i}" for i in range(n)]
        return stream, np.arange(n)

    saved = trainer_mod.build_stream
    trainer_mod.build_stream = streams
    try:
        trainer = trainer_mod.Trainer(config, device=device)
    finally:
        trainer_mod.build_stream = saved
    # the epoch log lines would bury the result; warnings still show
    logging.getLogger("libcontinual_torch").setLevel(logging.WARNING)
    return trainer


def bring_to(trainer, task: int):
    """Train tasks 0..task-1 as ``train_loop`` does and start ``task``;
    returns its training data and schedule."""
    from libcontinual_tpu_torch.core.optim import make_schedule

    method, cfg = trainer.method, trainer.config
    for t in range(task + 1):
        lo, hi = trainer.train_stream.class_range(t)
        task_data = trainer.train_stream.task(t)
        trainer.state = method.start_task(trainer.state, t, lo, hi)
        trainer.state = method.before_task(trainer.state, t, task_data)
        data = trainer._train_data(t, task_data)
        trainer.state = method.reset_optimizer(trainer.state, t)
        steps = -(-len(data) // trainer.batch_size)
        epochs = method.epochs_for_task(t, trainer.init_epoch if t == 0 else trainer.inc_epoch)
        sched = method.override_schedule(t, steps, epochs) or make_schedule(cfg, steps, epochs, t)
        if t == task:
            return data, sched
        trainer._train_task(t, data, sched, epochs)
        trainer.state = method.after_task(trainer.state, t, task_data)
        trainer._update_buffer(t, task_data)
        trainer.state = method.extra_phases(trainer, trainer.state, t, task_data)
    raise ValueError(f"task {task} is not in the stream")


def run_steps(trainer, task: int, data, sched, on_step: Callable) -> None:
    """One ``_train_task`` epoch in which ``on_step(i, state, batch, lr,
    metrics)`` sees step i (from 1) after it ran; it ends the epoch by
    raising ``_Stop``."""
    method = trainer.method
    step = method.train_step
    count = [0]

    def observed(state, batch, lr):
        state, m = step(state, batch, lr)
        count[0] += 1
        on_step(count[0], state, batch, lr, m)
        return state, m

    method.train_step = observed
    try:
        trainer._train_task(task, data, sched, 1)
    except _Stop:
        pass
    finally:
        del method.train_step


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in tensors.items()}


def first_steps(trainer, task: int, data, sched, start: Dict[str, torch.Tensor]) -> Dict:
    """Run ``WARM_STEPS`` steps; record the first three's batches, learning
    rates and losses, the first gradient (from the optimizer's state after
    step 1: its norm and the tensor) and the norm of the parameters' change
    after step 3, a leaf."""
    rec: Dict = {"batches": [], "losses": []}

    def on_step(i, state, batch, lr, m):
        if i <= CHECKED_STEPS:
            rec["batches"].append({k: v.detach().clone() for k, v in batch.items()}
                                  | {"lr": float(lr)})
            rec["losses"].append(float(m["loss"]))
        named = dict(state.params.named_parameters())
        if i == 1:
            rec["grad_vec"] = {n: check.first_grad(state.opt_state, p, start[n]).detach().clone()
                               for n, p in named.items()}
            rec["grad"] = _leaf_norms(rec["grad_vec"])
        if i == CHECKED_STEPS:
            rec["change"] = _leaf_norms({n: p.detach() - start[n].to(p.dtype)
                                         for n, p in named.items()})
        if i >= WARM_STEPS:
            raise _Stop

    run_steps(trainer, task, data, sched, on_step)
    return rec


def window(trainer, task: int, data, sched, seconds: float, device) -> Dict:
    """Whole epochs until ``seconds`` have passed; images, steps, non-finite
    losses and seconds."""
    seen = {"steps": 0, "bad": 0}

    def hook(task_idx, epoch_idx, state, losses):
        seen["steps"] += len(losses)
        seen["bad"] += int(np.sum(~np.isfinite(losses)))

    trainer.epoch_hook = hook
    _sync(device)
    t0 = time.perf_counter()
    images = 0
    try:
        while True:
            trainer._train_task(task, data, sched, 1)
            images += len(data)
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        trainer.epoch_hook = None
    t1 = time.perf_counter()
    return {"t0": t0, "seconds": t1 - t0, "images": images, **seen}


def profiled(trainer, task: int, data, sched, steps: int, cpu: bool, device) -> Dict:
    """Profile ``steps`` steps inside an epoch (after two unprofiled ones),
    between two device synchronisations; the events and the attention
    launches."""
    prof = trace.profiler(cpu or torch.device(device).type != "cuda")
    launches: List = []
    recorder = trace.record_launches(launches)
    skip = 2

    def on_step(i, state, batch, lr, m):
        if i == skip:
            _sync(device)
            prof.start()
            recorder.__enter__()
        elif i == skip + steps:
            _sync(device)
            recorder.__exit__(None, None, None)
            prof.stop()
            raise _Stop

    run_steps(trainer, task, data, sched, on_step)
    return {"events": trace.events_of(prof), "launches": launches}


def setup(ctx) -> Dict:
    """Everything before the window: the trainer at the cell's task with the
    benchmark's weights, and the recorded first steps. ``phases`` holds the
    seconds each part took, from process start."""
    device = torch.device(ctx.device)
    cfg, tr = ctx.config, ctx.traffic
    task = int(tr["task"])
    marks = [("start", time.perf_counter())]
    arrays = traffic.generate(tr, ctx.seed, device)
    marks.append(("traffic", time.perf_counter()))
    trainer = build_trainer(cfg, arrays, device)
    marks.append(("trainer", time.perf_counter()))
    data, sched = bring_to(trainer, task)
    marks.append(("earlier_tasks", time.perf_counter()))
    made = weights.make(ctx.cfgmod.weight_spec(cfg), ctx.seed, device)
    for group, values in made.items():
        weights.install(ctx.cfgmod.GROUPS[group](trainer.state), values)
    aug_seed = (int(ctx.seed) * 31 + 7) % (2 ** 63)
    trainer.state.rng = torch.Generator(device=device)
    trainer.state.rng.manual_seed(aug_seed)
    marks.append(("weights", time.perf_counter()))
    start = {n: made["params"][n] for n, _ in trainer.state.params.named_parameters()}
    rec = first_steps(trainer, task, data, sched, start)
    marks.append(("first_steps", time.perf_counter()))
    phases = {"imports": marks[0][1] - ctx.t_start}
    phases.update({name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])})
    return {"trainer": trainer, "data": data, "sched": sched, "task": task, "weights": made,
            "aug_seed": aug_seed, "rec": rec, "phases": phases}


def free(device) -> None:
    """Release the program's memory before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> Dict:
    device = torch.device(ctx.device)
    s = setup(ctx)
    trainer, data, sched, task = s["trainer"], s["data"], s["sched"], s["task"]
    win = window(trainer, task, data, sched, ctx.seconds, device)
    rate = win["images"] / win["seconds"]
    out: Dict = {"e2e": {"setup_s": win["t0"] - ctx.t_start, "train_img_per_s": rate},
                 "attempted": win["steps"], "failed": win["bad"], "phases": s["phases"]}
    if ctx.trace:
        k = int(ctx.cell.get("profile_steps", 5))
        a = profiled(trainer, task, data, sched, k, False, device)
        b = profiled(trainer, task, data, sched, max(2, k // 2), True, device)
        host = trace.summarize(b["events"])
        out["trace"] = {
            "steps": k, "launches": a["launches"], "img_per_s": rate,
            "flops_per_image": ctx.cfgmod.flops_per_image(ctx.config, ctx.traffic),
            **trace.summarize(a["events"]),
            "idle_gaps": trace.label_gaps(b["events"], host.get("gaps", [])),
        }
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    made, aug_seed, rec = s["weights"], s["aug_seed"], s["rec"]
    del s, trainer, data, sched
    free(device)
    ref = ctx.cfgmod.reference(ctx.config, made, rec["batches"], aug_seed, task)
    out["checks"] = check.readings(rec, ref)
    return out
