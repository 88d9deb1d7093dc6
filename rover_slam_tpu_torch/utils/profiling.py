"""Device-level tracing on torch.profiler.

Counterpart of rover_slam_tpu/utils/profiling.py. Host-side stage timers
live in utils/timing.py; this module adds the device view: a profiler trace
of CPU and CUDA activity written as a Chrome trace (chrome://tracing,
Perfetto), and named host spans that show up on its timeline.

Usage:
    from rover_slam_tpu_torch.utils.profiling import device_trace, annotate
    with device_trace("slam_trace"):
        with annotate("track_frame"):
            slam.track_frame(...)
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Record CPU activity, and CUDA activity where a card is present, and
    write it to `logdir`/trace.json (logdir None: rover_slam_trace in the
    temporary directory). Yields logdir."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "rover_slam_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named host span, visible on the trace timeline alongside device ops."""
    return torch.profiler.record_function(name)


def step_annotate(name: str, step_num: int):
    """Frame- or step-scoped span, named f"{name}#{step_num}"."""
    return torch.profiler.record_function(f"{name}#{step_num}")
