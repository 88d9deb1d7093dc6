"""Helpers the per-layer readers share over a traced run's record (built by
harness.build_record): the window's frames with their latency, whether the
profiler was on, whether the keyframe or loop count rose and their
StageTimers samples; the LightGlue and B2 calls with their shapes; and the
traced stretch's device activity."""
from __future__ import annotations

import numpy as np


def unprofiled(rec: dict) -> list:
    """The window's frames the profiler did not slow."""
    return [f for f in rec["frames"] if not f["profiled"]]


def stage_median_ms(rec: dict, stage: str):
    """Median of a StageTimers stage over the unprofiled frames (None if the
    stage never ran there)."""
    vals = [v for f in unprofiled(rec) for v in (f["stages"] or {}).get(stage, [])]
    return float(np.median(vals)) if vals else None


def device_us(rec: dict, names) -> float:
    """Device time in the stretch of the operations whose name contains one
    of names."""
    return sum(t for op, (t, _) in rec["trace"]["device_ops"].items()
               if any(n in op for n in names))


def per_stretch_frame(rec: dict, value: float):
    n = rec["trace"]["frames"]
    return value / n if n else None
