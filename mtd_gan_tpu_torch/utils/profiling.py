"""Profiling hooks (counterpart of ``mtd_gan_tpu/utils/profiling.py``):
a ``torch.profiler`` trace of a block of code written as a Chrome trace, and
a per-step wall-time histogram."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block (CPU, and CUDA where a GPU is present) and write
    ``<log_dir>/trace.json`` (open with Perfetto or chrome://tracing); does
    nothing when ``log_dir`` is empty."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step wall-time histogram: ``with timer: ...`` records one step.
    With ``sync``, each step ends with ``torch.cuda.synchronize()``, so the
    device work the step enqueued is charged to it."""

    def __init__(self, sync: bool = False):
        self.times = []
        self.sync = sync
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        return {"steps": n, "total_s": sum(ts), "mean_s": sum(ts) / n,
                "p50_s": ts[n // 2], "p95_s": ts[int(n * 0.95)], "max_s": ts[-1]}
