"""Metric meters and step logging (counterpart of devit_tpu/train/meters.py:
SmoothedValue and MetricLogger, a copy). Pure host-side bookkeeping."""

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
