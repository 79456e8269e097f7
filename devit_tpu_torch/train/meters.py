"""Metric meters and step logging (counterpart of devit_tpu/train/meters.py:
SmoothedValue, MetricLogger and create_logger, a copy). Pure host-side
bookkeeping."""

from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Optional

import numpy as np


class SmoothedValue:
    """Windowed median/avg + global avg."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               value=self.value, count=self.count)


class MetricLogger:
    """Iteration logger."""

    def __init__(self, delimiter: str = "  ", log_fn=print):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.log_fn = log_fn

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable, print_freq: int, header: str = "", total: Optional[int] = None):
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = -1
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i) if total > 0 else 0.0
                self.log_fn(
                    f"{header} [{i}{'/' + str(total) if total > 0 else ''}] "
                    f"eta: {datetime.timedelta(seconds=int(eta))} {self} "
                    f"time: {iter_time} data: {data_time}"
                )
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.log_fn(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")


def create_logger(output_dir: Optional[str] = None, name: str = "devit_tpu_torch"):
    """Console (rank 0 only) + per-rank file logger (reference
    utils/logger.py:12-35; the JAX package's create_logger): log.txt in
    output_dir on rank 0 and log_rank{r}.txt on rank r, re-pointed when
    several stage mains run in one process with different output dirs."""
    import logging
    import os

    from devit_tpu_torch.runtime import rank as process_rank

    rank = process_rank()
    logger = logging.getLogger(name)
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%H:%M:%S")
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        logger.setLevel(logging.INFO)
        if rank == 0:
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            logger.addHandler(sh)
        logger.propagate = False
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fname = "log.txt" if rank == 0 else f"log_rank{rank}.txt"
        target = os.path.abspath(os.path.join(output_dir, fname))
        file_handlers = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if not any(os.path.abspath(h.baseFilename) == target for h in file_handlers):
            for h in file_handlers:
                logger.removeHandler(h)
                h.close()
            fh = logging.FileHandler(target)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
