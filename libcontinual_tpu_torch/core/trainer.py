"""The task-incremental trainer (``libcontinual_tpu/core/trainer.py``).

The same task loop, batch order, replay buffer, evaluation and acc-table
bookkeeping as the JAX trainer, on one device:

  * each task's uint8 arrays, with the replay buffer's behind them, go to
    the device once; a batch is an on-device index into them;
  * after each task the buffer is updated (herding ranks the method's
    features) and the method hears of it (``on_buffer_updated``);
  * the epoch's shuffle comes from ``data.native.shuffled_indices``, so the
    batch order equals the JAX run's for the same seed;
  * an epoch is a Python loop of train steps, the per-step learning rate
    passed in as data;
  * evaluation fills the acc table, forgetting and BWT as the JAX trainer
    does;
  * spans (``utils/trace.py``) cover the build, each task, epoch and step,
    the task boundary and evaluation; ``profile: true`` records them for the
    whole run, writes them to ``events.jsonl`` at the end, and writes a
    ``torch.profiler`` Chrome trace of task 0's second epoch (its first if
    it has only one) to ``save_path``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import libcontinual_tpu_torch.methods  # noqa: F401  (registers the methods)
from libcontinual_tpu_torch.core.buffer import LinearBuffer, build_buffer
from libcontinual_tpu_torch.core.metrics import compute_bwt, compute_frgt, count_parameters
from libcontinual_tpu_torch.core.optim import make_schedule
from libcontinual_tpu_torch.data import native
from libcontinual_tpu_torch.data.continual import TaskData, build_stream
from libcontinual_tpu_torch.registry import METHODS
from libcontinual_tpu_torch.utils import get_logger, init_seed
from libcontinual_tpu_torch.utils.trace import TRACER


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Trainer:
    #: optional ``(task_idx, epoch_idx, state, step_losses) -> None`` called
    #: after every training epoch: a read-only observation point
    epoch_hook = None

    def __init__(self, config: Dict[str, Any], workdir: Optional[str] = None,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.log = get_logger(workdir or config.get("save_path") or None)
        self.log.event("config", **{k: v for k, v in config.items()
                                    if not isinstance(v, (list, dict))})
        self.log.info(
            "method=%s backbone=%s dataset=%s tasks=%d (%d+%dx) device=%s",
            config["classifier"]["name"], config["backbone"]["name"],
            config.get("dataset"), config["task_num"],
            config["init_cls_num"], config["inc_cls_num"], self.device,
        )
        seed = int(config.get("seed", 0))
        init_seed(seed, bool(config.get("deterministic", True)))
        if (config.get("checkpoint") or {}).get("enable"):
            raise NotImplementedError("checkpoints are not in the PyTorch port yet")
        self.profile = bool(config.get("profile"))
        #: the recording period of a ``profile: true`` run, until train_loop ends it
        self._trace_period = TRACER.begin() if self.profile else None
        with TRACER.span("trainer.build"):
            self._build(config, seed)

    def _build(self, config: Dict[str, Any], seed: int) -> None:
        self.task_num = int(config["task_num"])
        self.init_cls_num = int(config["init_cls_num"])
        self.inc_cls_num = int(config["inc_cls_num"])
        self.batch_size = int(config.get("train_batch_size", config["batch_size"]))
        self.test_batch_size = int(config.get("test_batch_size", self.batch_size))
        self.val_per_epoch = int(config.get("val_per_epoch", 1))
        self.setting = config.get("setting", "task-agnostic")
        self.init_epoch = int(config.get("init_epoch", config["epoch"]))
        self.inc_epoch = int(config["epoch"])

        with TRACER.span("trainer.streams"):
            self.train_stream, cls_map = build_stream(config, "train")
            self.test_stream, _ = build_stream(config, "test", cls_map)

        self.buffer: LinearBuffer = build_buffer(config, self.device)
        with TRACER.span("method.build"):
            self.method = METHODS.get(config["classifier"]["name"])(config, self.device)
        # the CLIP methods' class prompts read the stream's class names
        self.method.class_names = getattr(self.train_stream, "class_names", [])

        hwc = self.train_stream.task(0).images.shape[1:]
        with TRACER.span("method.init_state"):
            self.state = self.method.init_state(seed, hwc)
        self.acc_table = np.zeros((self.task_num, self.task_num))
        self._dev_data_cache: Dict[int, Any] = {}

    # ------------------------------------------------------------------- data

    def _epoch_indices(self, n: int, epoch_seed: int):
        """Shuffled, padded index matrix + weights (pad positions weigh 0)."""
        perm = native.shuffled_indices(n, epoch_seed)
        steps = _ceil_div(n, self.batch_size)
        total = steps * self.batch_size
        pad = total - n
        idx = np.resize(perm, total) if pad else perm
        weights = np.ones(total, np.float32)
        if pad:
            weights[n:] = 0.0
        return (
            idx.reshape(steps, self.batch_size).astype(np.int64),
            weights.reshape(steps, self.batch_size),
        )

    def _device_task_data(self, td: TaskData, cache: bool = False):
        hit = self._dev_data_cache.get(id(td)) if cache else None
        if hit is not None and hit[0] is td:
            return hit[1], hit[2]
        images = torch.from_numpy(np.ascontiguousarray(td.images)).to(self.device)
        labels = torch.from_numpy(td.labels.astype(np.int64)).to(self.device)
        if cache:  # test sets are immutable: upload once per run
            self._dev_data_cache[id(td)] = (td, images, labels)
        return images, labels

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ train

    def _epoch_profiler(self, task_idx: int, epoch_idx: int, epochs: int):
        """A ``profile: true`` run's ``torch.profiler`` over task 0's epoch 1
        (epoch 0 of a one-epoch task), written as a Chrome trace to
        ``save_path``; else a null context."""
        save = self.config.get("save_path")
        if not (self.profile and save and task_idx == 0 and epoch_idx == min(1, epochs - 1)):
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                                         else [])
        path = os.path.join(save, f"trace_task{task_idx}_epoch{epoch_idx}.json")
        self.log.info("profiler trace of task %d epoch %d -> %s", task_idx, epoch_idx, path)
        return profile(activities=acts, on_trace_ready=lambda p: p.export_chrome_trace(path))

    def _train_task(self, task_idx: int, task_data: TaskData, sched, epochs: int) -> None:
        method = self.method
        n = len(task_data)
        seed = int(self.config.get("seed", 0))
        for epoch_idx in range(epochs):
            with self._epoch_profiler(task_idx, epoch_idx, epochs), \
                    TRACER.span("trainer.epoch", task=task_idx, epoch=epoch_idx):
                with TRACER.span("epoch.prepare"):
                    if epoch_idx == 0:  # the task's images go to the device once
                        images, labels = self._device_task_data(task_data)
                    idx, weights = self._epoch_indices(n, seed + task_idx * 100003 + epoch_idx)
                    lrs = sched.step_lrs(epoch_idx)
                    steps = idx.shape[0]
                    if len(lrs) < steps:
                        lrs = np.resize(lrs, steps)
                    lrs = lrs[:steps].astype(np.float32)
                    idx_d = torch.from_numpy(idx).to(self.device)
                    w_d = torch.from_numpy(weights).to(self.device)

                t0 = time.perf_counter()
                losses, accs = [], []
                for s in range(steps):
                    with TRACER.span("trainer.step", step=s):
                        with TRACER.span("step.batch"):
                            batch = {"image": images[idx_d[s]], "label": labels[idx_d[s]],
                                     "weight": w_d[s]}
                        self.state, m = method.train_step(self.state, batch, float(lrs[s]))
                        losses.append(m["loss"])
                        accs.append(m["acc"])
                with TRACER.span("epoch.drain"):
                    ms = {
                        "loss": torch.stack(losses).float().cpu().numpy(),
                        "acc": torch.stack(accs).float().cpu().numpy(),
                        "w": weights.sum(axis=1),
                    }
                    self._sync()
                dt = time.perf_counter() - t0

                wsum = float(np.sum(ms["w"])) or 1.0
                ep_loss = float(np.sum(ms["loss"] * ms["w"]) / wsum)
                ep_acc = float(np.sum(ms["acc"] * ms["w"]) / wsum)
                if self.epoch_hook is not None:
                    self.epoch_hook(task_idx, epoch_idx, self.state, ms["loss"])
                ips = wsum / dt
                self.log.info(
                    "Task %d epoch [%d/%d] lr %.5f | loss %.4f acc %.2f | %.0f img/s",
                    task_idx, epoch_idx, epochs, float(lrs[0]), ep_loss, ep_acc * 100, ips,
                )
                self.log.event(
                    "train_epoch", task=task_idx, epoch=epoch_idx, loss=ep_loss,
                    acc=ep_acc, images_per_sec=ips, lr=float(lrs[0]),
                )
                if (
                    method.validate_enabled
                    and self.val_per_epoch > 0
                    and (epoch_idx + 1) % self.val_per_epoch == 0
                    and bool(self.config.get("eval_with_test", True))
                    and epochs > 1
                    and epoch_idx + 1 < epochs
                ):
                    res = self._validate(task_idx)
                    self.log.info(" * val: avg %.2f per-task %s", res["avg_acc"],
                                  res["per_task_acc"])
                sched.observe(ep_loss)
            if sched.should_stop():
                self.log.info("PatienceSchedule lr below stopping_lr; ending task")
                break

    # ------------------------------------------------------------------- eval

    def _eval_task_data(self, td: TaskData, task_id: int):
        n = len(td)
        bs = self.test_batch_size
        steps = _ceil_div(n, bs)
        # the last batch wraps around and its tail weighs 0, as in the JAX
        # trainer: batch-level choices (L2P's majority vote) see the same batch
        idx = torch.arange(steps * bs, device=self.device)
        weights = (idx < n).float().reshape(steps, bs)
        idx = (idx % n).reshape(steps, bs)
        images, labels = self._device_task_data(td, cache=True)
        correct = torch.zeros((), dtype=torch.float32, device=self.device)
        for s in range(steps):
            batch = {"image": images[idx[s]], "label": labels[idx[s]]}
            preds = self.method.eval_step(self.state, batch, task_id)
            correct += ((preds == batch["label"]).float() * weights[s]).sum()
        TRACER.count("eval.images", n)
        return int(round(float(correct))), n

    def _validate(self, task_idx: int) -> Dict[str, Any]:
        """Per-task accuracies on tasks 0..task_idx."""
        per_task_acc: List[float] = []
        correct_all, count_all = 0, 0
        with TRACER.span("trainer.eval", task=task_idx):
            for t, td in enumerate(self.test_stream.tasks_up_to(task_idx)):
                tid = t if self.setting == "task-aware" else -1
                c, n = self._eval_task_data(td, tid)
                correct_all += c
                count_all += n
                per_task_acc.append(round(c * 100.0 / max(n, 1), 2))
        return {
            "avg_acc": round(correct_all * 100.0 / max(count_all, 1), 2),
            "per_task_acc": per_task_acc,
        }

    # -------------------------------------------------------------- main loop

    def train_loop(self) -> Dict[str, Any]:
        """Every task in turn; a ``profile: true`` run's spans and counters
        go to ``events.jsonl`` at the end."""
        try:
            return self._train_loop()
        finally:
            period, self._trace_period = self._trace_period, None
            if period is not None:
                TRACER.end()
                period.export(self.log)

    def _train_loop(self) -> Dict[str, Any]:
        cfg = self.config
        t_begin = time.time()
        method = self.method
        batch_last_acc_list = np.zeros(self.task_num)
        task_last_acc_list = np.zeros(self.task_num)
        frgt_list, bwt_list = [], []
        for task_idx in range(self.task_num):
            with TRACER.span("trainer.task", task=task_idx):
                self.log.info("================ Task %d start ================", task_idx)
                lo, hi = self.train_stream.class_range(task_idx)
                task_data = self.train_stream.task(task_idx)
                self.state = method.start_task(self.state, task_idx, lo, hi)
                self.state = method.before_task(self.state, task_idx, task_data)
                train_data = self._train_data(task_idx, task_data)
                self.state = method.reset_optimizer(self.state, task_idx)
                steps_per_epoch = _ceil_div(len(train_data), self.batch_size)
                epochs = method.epochs_for_task(
                    task_idx, self.init_epoch if task_idx == 0 else self.inc_epoch)
                sched = method.override_schedule(task_idx, steps_per_epoch, epochs)
                if sched is None:
                    sched = make_schedule(cfg, steps_per_epoch, epochs, task_idx)
                self.log.info(
                    "training samples: %d | params: %d",
                    len(train_data), count_parameters(self.state.params),
                )
                if epochs > 0:
                    self._train_task(task_idx, train_data, sched, epochs)
                with TRACER.span("trainer.boundary"):
                    with TRACER.span("method.after_task"):
                        self.state = method.after_task(self.state, task_idx, task_data)
                    self._update_buffer(task_idx, task_data)
                    with TRACER.span("method.extra_phases"):
                        self.state = method.extra_phases(self, self.state, task_idx, task_data)

                res = self._validate(task_idx)
                per_task_acc = np.asarray(res["per_task_acc"])
                batch_last_acc_list[task_idx] = res["avg_acc"]
                task_last_acc_list[task_idx] = float(np.mean(per_task_acc))
                self.acc_table[task_idx, : task_idx + 1] = per_task_acc
                frgt = compute_frgt(self.acc_table, self.acc_table[task_idx], task_idx)
                bwt = compute_bwt(self.acc_table, self.acc_table[task_idx], task_idx)
                if task_idx > 1:
                    frgt_list.append(frgt)
                    bwt_list.append(bwt)
                self.log.info("================ Task %d result ================", task_idx)
                self.log.info(
                    " * [Batch] last avg acc: %.2f | [Task] last avg acc: %.2f",
                    res["avg_acc"], task_last_acc_list[task_idx],
                )
                self.log.info(" * frgt %.3f bwt %.2f", frgt, bwt)
                self.log.info(" * per-task acc: %s", res["per_task_acc"])
                self.log.event(
                    "task_done", task=task_idx, avg_acc=res["avg_acc"],
                    per_task_acc=res["per_task_acc"], frgt=frgt, bwt=bwt,
                )

        t_idx = self.task_num - 1
        overall = {
            "acc_table": self.acc_table,
            "last_avg_acc": float(batch_last_acc_list[t_idx]),
            "batch_ovr_avg_acc": float(np.mean(batch_last_acc_list)),
            "task_ovr_avg_acc": float(
                np.sum(np.sum(self.acc_table[: t_idx + 1], axis=1) / np.arange(1, t_idx + 2))
                / (t_idx + 1)
            ),
            "ovr_frgt": float(np.mean(frgt_list)) if frgt_list else float("inf"),
            "ovr_bwt": float(np.mean(bwt_list)) if bwt_list else float("-inf"),
            "time_sec": time.time() - t_begin,
        }
        overall["fps"] = self._compute_fps()
        self.log.info("================ Overall ================")
        self.log.info(
            " * last avg acc %.2f | overall avg acc %.2f | frgt %.3f | bwt %.2f",
            overall["last_avg_acc"], overall["batch_ovr_avg_acc"],
            overall["ovr_frgt"], overall["ovr_bwt"],
        )
        self.log.info(" * time %.1fs | inference fps %.0f", overall["time_sec"], overall["fps"])
        self.log.event("run_done", **{k: v for k, v in overall.items() if k != "acc_table"})
        return overall

    # ----------------------------------------------------------------- buffer

    def _train_data(self, task_idx: int, task_data: TaskData) -> TaskData:
        """The method's own training data, else the task's images followed
        by the replay buffer's (from the second task on)."""
        custom = self.method.build_train_data(task_data, self.buffer, task_idx)
        if custom is not None:
            return custom
        if (self.method.concat_buffer and self.buffer.buffer_size > 0 and task_idx > 0
                and len(self.buffer) > 0):
            return task_data.concat(self.buffer.as_task_data())
        return task_data

    def _update_buffer(self, task_idx: int, task_data: TaskData) -> None:
        if not self.method.concat_buffer:
            return
        self.buffer.total_classes += self.init_cls_num if task_idx == 0 else self.inc_cls_num
        if self.buffer.buffer_size > 0:
            with TRACER.span("buffer.update", task=task_idx):
                self.buffer.update(task_data, feature_fn=self._batched_features,
                                   seed=int(self.config.get("seed", 0)) + task_idx)
                self.state = self.method.on_buffer_updated(self.state, task_idx, self.buffer)

    def _batched_features(self, images_uint8: np.ndarray) -> np.ndarray:
        """Eval-mode features of host images in batches of ``batch_size``;
        the last batch is padded by repeating its last image."""
        outs = []
        bs = self.batch_size
        for lo in range(0, len(images_uint8), bs):
            chunk = images_uint8[lo:lo + bs]
            pad = bs - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            x = self.method.augment(None, torch.from_numpy(chunk).to(self.device), train=False)
            f = self.method.herding_features(self.state, x).float().cpu().numpy()
            outs.append(f[: bs - pad])
        return np.concatenate(outs)

    # ------------------------------------------------------------------ misc

    def _compute_fps(self) -> float:
        """Inference throughput probe: timed eval steps on one test batch."""
        td = self.test_stream.task(0)
        bidx = np.resize(np.arange(min(self.batch_size, len(td))), self.batch_size)
        batch = {
            "image": torch.from_numpy(td.images[bidx]).to(self.device),
            "label": torch.from_numpy(td.labels[bidx].astype(np.int64)).to(self.device),
        }
        self.method.eval_step(self.state, batch, -1)  # warm-up
        self._sync()
        n_iter = 30
        t0 = time.perf_counter()
        for _ in range(n_iter):
            self.method.eval_step(self.state, batch, -1)
        self._sync()
        return n_iter * self.batch_size / (time.perf_counter() - t0)
