"""Training meters, progress printing and the per-epoch TensorBoard sink
(counterpart of ``mtd_gan_tpu/utils/logging.py``; reference
utils.py:9-138, train.py:176-262)."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch


class SmoothedValue:
    """A window of the last values (20) plus the running total."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        value = float(value)
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
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class TensorBoardSink:
    """Per-epoch scalars to ``log_dir`` (``<checkpoint-dir>/runs``); does
    nothing where ``tensorboardX`` is not installed."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(log_dir)

    def scalars(self, stats: Dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, step)
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def global_averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  pre_print: Optional[Callable[[], None]] = None):
        """Yields the items of ``iterable``; every ``print_freq`` items it
        runs ``pre_print`` (where deferred device metrics are synced) and
        prints ETA, meters, iteration and data time and the peak device
        memory."""
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if pre_print is not None:
                    pre_print()
                eta = (str(datetime.timedelta(
                    seconds=int(iter_time.global_avg * (total - i))))
                    if total else "?")
                mem = (f"  max mem: {torch.cuda.max_memory_allocated() / 2**20:.0f}MB"
                       if torch.cuda.is_available() else "")
                count = f"[{i}/{total}]" if total else f"[{i}]"
                print(f"{header} {count}  eta: {eta}  {self}  time: {iter_time}  "
                      f"data: {data_time}{mem}", flush=True)
            end = time.time()
        elapsed = datetime.timedelta(seconds=int(time.time() - start))
        print(f"{header} Total time: {elapsed}", flush=True)
