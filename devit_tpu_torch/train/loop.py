"""Host-side epoch orchestration (counterpart of devit_tpu/train/loop.py):
run_eval, train_epoch with its one-step-lagged metrics pull and NaN guard,
and fit. The port runs in one process; fit's checkpoint, profiler and
TensorBoard hooks come with the checkpoint/CLI slice and raise until then.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from devit_tpu_torch.data.datasets import pad_batch_to_steady
from devit_tpu_torch.train.meters import MetricLogger


class NonFiniteLossError(RuntimeError):
    pass


def run_eval(eval_step: Callable, variables, gates, batches: Iterable, *,
             prepare=None) -> Dict[str, float]:
    """Aggregate summed counters over the val set -> {'acc1','acc5','loss'}.
    The ragged tail batch is padded to the steady shape (labels -1 count
    nowhere)."""
    totals = {"loss_sum": 0.0, "top1": 0, "top5": 0, "count": 0}
    batch_size = None
    for images, labels in batches:
        images, labels, batch_size, _ = pad_batch_to_steady(images, labels, batch_size)
        if prepare is not None:
            images = prepare(images)
        out = eval_step(variables, gates, images, labels)
        for k in totals:
            totals[k] += float(out[k])
    n = max(totals["count"], 1)
    return {"acc1": 100.0 * totals["top1"] / n, "acc5": 100.0 * totals["top5"] / n,
            "loss": totals["loss_sum"] / n}


def train_epoch(step_fn: Callable, carry, batches: Iterable, generator: torch.Generator, *,
                epoch: int, log_fn=print, print_freq: int = 10, nan_abort: bool = True):
    """One epoch. `step_fn(carry, images, labels, generator) -> (carry,
    metrics)`. Step i's metrics are read (and the NaN guard checked) after
    step i+1 is queued, so the host keeps ahead of the device; a non-finite
    loss therefore aborts one step later than the reference."""
    logger = MetricLogger(log_fn=log_fn)
    header = f"Epoch: [{epoch}]"

    def pull(metrics):
        host = {k: float(v) for k, v in metrics.items()}
        if nan_abort and not math.isfinite(host.get("loss", 0.0)):
            raise NonFiniteLossError(f"Loss is {host.get('loss')}, stopping training")
        logger.update(**host)

    pending = None
    for images, labels in logger.log_every(batches, print_freq, header):
        carry, metrics = step_fn(carry, images, labels, generator)
        if pending is not None:
            pull(pending)
        pending = metrics
    if pending is not None:
        pull(pending)
    return carry, logger.averages(), generator


def _epoch_generator(generator: torch.Generator, epoch: int) -> torch.Generator:
    """A generator per epoch from the caller's seed and the epoch (jax's
    fold_in), so a resume from epoch k replays the uninterrupted run."""
    g = torch.Generator(device=generator.device)
    g.manual_seed((generator.initial_seed() * 1_000_003 + epoch) % (2 ** 63))
    return g


def fit(*, carry, step_fn: Callable, train_batches_fn: Callable[[int], Iterable],
        eval_fn: Callable[[object], Dict[str, float]], epochs: int,
        generator: torch.Generator, output_dir: Optional[str] = None, log_fn=print,
        save_state_fn: Optional[Callable] = None, start_epoch: int = 0,
        profile_dir: Optional[str] = None, tensorboard: bool = False):
    """Epoch loop + eval + best accuracy + stats (log_stats.txt, result.txt
    in output_dir). save_state_fn(path, carry, epoch) persists resumable
    state, as the JAX package's fit calls it: checkpoint_temp.msgpack after
    every epoch's training (before its eval), checkpoint.msgpack at a new
    best acc1. Returns (carry, best_acc1)."""
    for name, value in (("profile_dir", profile_dir), ("tensorboard", tensorboard)):
        if value:
            raise NotImplementedError(f"fit({name}=...) is still to port (the CLI slice)")
    best_acc = -1.0
    stats_path = os.path.join(output_dir, "log_stats.txt") if output_dir else None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        carry, train_stats, _ = train_epoch(step_fn, carry, train_batches_fn(epoch),
                                            _epoch_generator(generator, epoch), epoch=epoch,
                                            log_fn=log_fn)
        if output_dir and save_state_fn is not None:
            save_state_fn(os.path.join(output_dir, "checkpoint_temp.msgpack"), carry, epoch)
        eval_stats = eval_fn(carry)
        log_fn(f"epoch {epoch}: train loss {train_stats.get('loss', float('nan')):.4f} "
               f"val acc1 {eval_stats['acc1']:.2f} acc5 {eval_stats['acc5']:.2f} "
               f"({time.time() - t0:.1f}s)")
        if eval_stats["acc1"] > best_acc:
            best_acc = eval_stats["acc1"]
            if output_dir and save_state_fn is not None:
                save_state_fn(os.path.join(output_dir, "checkpoint.msgpack"), carry, epoch)
            if output_dir:
                with open(os.path.join(output_dir, "result.txt"), "a") as f:
                    f.write(json.dumps({"epoch": epoch, "best_acc1": best_acc}) + "\n")
        if stats_path:
            with open(stats_path, "a") as f:
                f.write(json.dumps({"epoch": epoch,
                                    **{f"train_{k}": v for k, v in train_stats.items()},
                                    **{f"test_{k}": v for k, v in eval_stats.items()}}) + "\n")
    return carry, best_acc
