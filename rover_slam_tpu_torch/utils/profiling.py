"""The port's spans, counters and device traces.

Counterpart of rover_slam_tpu/utils/profiling.py, and the one
instrumentation system of the port: StageTimers (utils/timing.py) is the
sink its spans write host samples into.

span(name) times a piece of host work:
- host sample: the elapsed host ms is appended under `name` to a sink, the
  `samples` dict of a StageTimers: the span's own where StageTimers.stage
  opens it, else the sink of the frame being processed, which
  MonocularSLAM.track_frame sets with frame_sink. A span with no sink, or a
  kernel- or model-level span (sample=False), keeps no sample.
- profiler range: while a profiler records, the span is also a
  torch.profiler range of the same name, so it lands on the device trace's
  clock and nests under the span open around it.
- implicit syncs: while a profiler records and the caller has set
  torch.cuda.set_sync_debug_mode("warn"), each sync warning is counted
  against the innermost open span and handed on to the warning handler
  installed before; the span appends its count under "<name>/syncs" when it
  closes. No debug mode is ever set here.
With no profiler a span costs one flag check, plus the sample where it keeps
one. Names: "<layer>.<stage>" (PERF.md section 3 lists every span and
counter with the metric that reads it).

count(name, key) adds to a counter of the registry (the kernels' launch
counts); counter, counter_by, snapshot_counters and reset_counters read and
reset it.

device_trace(logdir) writes a Chrome trace of CPU and CUDA activity:
    with device_trace("slam_trace"):
        with span("track_frame"):
            slam.track_frame(...)
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import tempfile
import time
import warnings

import torch

TRACE_FILE = "trace.json"
SYNC_WORD = "synchroniz"   # what torch's sync debug warnings say

_NULL = contextlib.nullcontext()
_frame_sink = None         # samples dict of the frame being processed
_counting = []             # spans counting syncs, innermost last
_handler_before = None     # warnings.showwarning when the first of them opened
_counters: dict = {}       # name -> collections.Counter (key None: unkeyed)


def _profiler_on() -> bool:
    return torch.autograd._profiler_enabled()


def _sync_warn_on() -> bool:
    """Whether the caller has turned torch.cuda's sync debug mode on."""
    return torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() != 0


class _Span:
    __slots__ = ("name", "sink", "keep", "range", "counting", "syncs", "t0")

    def __init__(self, name, sink, keep, ranged):
        self.name, self.sink, self.keep = name, sink, keep
        self.range = torch.profiler.record_function(name) if ranged else None
        self.counting = False
        self.syncs = 0

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
            self.counting = _sync_warn_on()
            if self.counting:
                _start_counting(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1e3
        sink = self.sink
        if self.keep and sink is not None:
            sink.setdefault(self.name, []).append(ms)
        if self.counting:
            _stop_counting(self)
            if sink is not None:
                sink.setdefault(self.name + "/syncs", []).append(self.syncs)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, sample: bool = True, sink=None):
    """A span named `name` (see the module docstring). sink: the samples dict
    to write into (StageTimers.stage passes its own); None is the frame's.
    sample=False for kernel- and model-level spans."""
    ranged = _profiler_on()
    sink = _frame_sink if sink is None else sink
    if not ranged and not (sample and sink is not None):
        return _NULL
    return _Span(name, sink, sample, ranged)


def spanned(name: str, sample: bool = True):
    """Decorator: the function's every call runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, sample):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def frame_sink(samples):
    """Spans opened inside write their host samples into `samples` (a
    StageTimers' samples dict) unless they have their own."""
    global _frame_sink
    before, _frame_sink = _frame_sink, samples
    try:
        yield
    finally:
        _frame_sink = before


def sample(name: str, value: float):
    """Append a counted value (not a time) under name to the frame's sink,
    if one is set."""
    if _frame_sink is not None:
        _frame_sink.setdefault(name, []).append(value)


def _start_counting(sp: _Span):
    global _handler_before
    if not _counting:
        _handler_before = warnings.showwarning
        warnings.showwarning = _count_sync
    _counting.append(sp)


def _stop_counting(sp: _Span):
    _counting.remove(sp)
    if not _counting and warnings.showwarning is _count_sync:
        warnings.showwarning = _handler_before


def _count_sync(message, category, filename, lineno, file=None, line=None):
    """warnings.showwarning while spans count syncs."""
    if _counting and SYNC_WORD in str(message):
        _counting[-1].syncs += 1
    _handler_before(message, category, filename, lineno, file, line)


# --- counters ------------------------------------------------------------------

def count(name: str, key=None, n: int = 1):
    """Add n to counter `name` (under `key` for a counter kept by key)."""
    _counters.setdefault(name, collections.Counter())[key] += n


def counter(name: str) -> int:
    """Counter `name` since its last reset (summed over its keys)."""
    return sum(_counters.get(name, {}).values())


def counter_by(name: str) -> dict:
    """Counter `name` since its last reset by key."""
    return dict(_counters.get(name, {}))


def snapshot_counters() -> dict:
    """A copy of every counter, for reset_counters."""
    return {k: collections.Counter(v) for k, v in _counters.items()}


def reset_counters(to: dict | None = None):
    """Clear every counter, or set them back to a snapshot_counters()."""
    _counters.clear()
    for k, v in (to or {}).items():
        _counters[k] = collections.Counter(v)


# --- device trace --------------------------------------------------------------

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
