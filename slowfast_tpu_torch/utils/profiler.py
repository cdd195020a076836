"""Profiling utilities (counterpart of slowfast_tpu/utils/profiler.py).

``trace`` records a ``torch.profiler`` trace (CPU ops and, with a card, its
kernels) and writes it as a Chrome trace under ``log_dir``; ``StepTimer``
times steps on the host clock, each forced to completion.
"""

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import logging as logging_utils

logger = logging_utils.get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Profile the block; yields the profiler (None when not ``enabled``) and
    writes ``log_dir/trace.json`` (Perfetto, chrome://tracing) at its end."""
    if not enabled:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)


class StepTimer:
    """Host-clock step times after ``warmup`` steps, each step ended by a
    read-back of ``sync_value`` or, without one, ``torch.cuda.synchronize``
    (the card runs behind the host: a time taken without either measures
    the dispatch)."""

    def __init__(self, warmup=3):
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        if sync_value is not None:
            float(sync_value)  # waits for the value, so for the work before it
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self):
        if not self.times:
            return {}
        return {"steps": len(self.times), "mean_s": float(np.mean(self.times)),
                "p50_s": float(np.median(self.times)),
                "p90_s": float(np.percentile(self.times, 90))}
