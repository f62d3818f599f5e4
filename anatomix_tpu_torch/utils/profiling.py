"""Profiling hooks (the port's counterpart of
`anatomix_tpu/utils/profiling.py`): a `torch.profiler` trace, named ranges
in its timeline, and the reference's EMA wall-clock timers."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with CPU activities (and CUDA where a card is
    present); yields the profiler, whose `key_averages()` the caller may
    read, and writes a Chrome trace to `log_dir/trace.json` at exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range in the profiler's timeline (free when no profiler
    runs)."""
    with torch.profiler.record_function(name):
        yield


class EMATimer:
    """The reference's EMA iteration timers (`trainers/train.py:186-191`)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self) -> float:
        dt = time.time() - self._t0
        self.value = (dt if self.value == 0.0
                      else (1 - self.alpha) * self.value + self.alpha * dt)
        return self.value
