"""Host-side epoch orchestration (counterpart of devit_tpu/train/loop.py):
run_eval, train_epoch with its one-step-lagged metrics pull and NaN guard,
and fit with its checkpoint, profiler and TensorBoard hooks. File artifacts
are gated on runtime.is_main_process(), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from devit_tpu_torch.data.datasets import pad_batch_to_steady
from devit_tpu_torch.io.checkpoint import wait_for_checkpoints
from devit_tpu_torch.runtime import is_main_process
from devit_tpu_torch.train.meters import MetricLogger
from devit_tpu_torch.utils_profile import device_memory_stats, trace


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


def _summary_writer(output_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError("fit(tensorboard=True) needs the `tensorboard` package "
                          "(torch.utils.tensorboard imports it)") from e
    return SummaryWriter(log_dir=output_dir)


def fit(*, carry, step_fn: Callable, train_batches_fn: Callable[[int], Iterable],
        eval_fn: Callable[[object], Dict[str, float]], epochs: int,
        generator: torch.Generator, output_dir: Optional[str] = None, log_fn=print,
        save_state_fn: Optional[Callable] = None, start_epoch: int = 0,
        profile_dir: Optional[str] = None, tensorboard: bool = False):
    """Epoch loop + eval + best accuracy + stats (log_stats.txt, result.txt
    in output_dir). save_state_fn(path, carry, epoch) persists resumable
    state, as the JAX package's fit calls it: checkpoint_temp.msgpack after
    every epoch's training (before its eval), checkpoint.msgpack at a new
    best acc1. profile_dir: the first trained epoch runs under
    utils_profile.trace (a torch.profiler Chrome trace there) and the card's
    memory counters are logged after it. tensorboard: scalars to output_dir
    (tags Train/*, Test/Top1|Top5|loss). Returns (carry, best_acc1)."""
    best_acc = -1.0
    main = is_main_process()
    stats_path = os.path.join(output_dir, "log_stats.txt") if output_dir and main else None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    tb_writer = _summary_writer(output_dir) if tensorboard and output_dir and main else None
    try:
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            profiling = profile_dir is not None and epoch == start_epoch
            with trace(profile_dir) if profiling else contextlib.nullcontext():
                carry, train_stats, _ = train_epoch(
                    step_fn, carry, train_batches_fn(epoch), _epoch_generator(generator, epoch),
                    epoch=epoch, log_fn=log_fn)
            if profiling:
                mem = device_memory_stats()
                log_fn(f"profiler trace -> {profile_dir}" + (f" (HBM: {mem})" if mem else ""))
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
                if output_dir and main:
                    with open(os.path.join(output_dir, "result.txt"), "a") as f:
                        f.write(json.dumps({"epoch": epoch, "best_acc1": best_acc}) + "\n")
            if stats_path:
                with open(stats_path, "a") as f:
                    f.write(json.dumps({"epoch": epoch,
                                        **{f"train_{k}": v for k, v in train_stats.items()},
                                        **{f"test_{k}": v for k, v in eval_stats.items()}})
                            + "\n")
            if tb_writer is not None:
                for k, v in train_stats.items():
                    tb_writer.add_scalar(f"Train/{k}", float(v), epoch)
                tags = {"acc1": "Top1", "acc5": "Top5"}
                for k, v in eval_stats.items():
                    tb_writer.add_scalar(f"Test/{tags.get(k, k)}", float(v), epoch)
                tb_writer.flush()
    finally:
        if tb_writer is not None:
            tb_writer.close()
        # on every exit path: an async orbax write's failure surfaces only at
        # the next save or wait, and its '.new' is promoted here
        wait_for_checkpoints()
    return carry, best_acc
