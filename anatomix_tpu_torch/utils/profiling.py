"""Profiling hooks (the port's counterpart of
`anatomix_tpu/utils/profiling.py`): a `torch.profiler` trace and named
ranges in its timeline."""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


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


def annotate(name: str):
    """Named range in the profiler's timeline (a `record_function`), opened
    only while a profiler runs (`torch.profiler.profile`, `emit_nvtx`,
    `emit_itt`); otherwise a shared no-op context, one flag check."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
