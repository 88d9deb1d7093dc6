"""Per-stage wall-clock instrumentation (counterpart of
rover_slam_tpu/utils/timing.py): the sink of host samples that the spans of
utils/profiling.py write into. Stage names follow the JAX package:
lm_track, new_kf, flags_fetch."""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from . import profiling


class StageTimers:
    def __init__(self):
        self.samples = defaultdict(list)

    def stage(self, name: str):
        """profiling.span(name) whose host ms land in these samples."""
        return profiling.span(name, sink=self.samples)

    def add(self, name: str, ms: float):
        self.samples[name].append(ms)

    def summary(self) -> dict:
        out = {}
        for k, v in self.samples.items():
            if v:
                a = np.asarray(v)
                out[k] = {"mean_ms": float(a.mean()),
                          "median_ms": float(np.median(a)),
                          "max_ms": float(a.max()),
                          "count": len(v)}
        return out

    def report(self) -> str:
        lines = ["stage              mean_ms  median_ms  max_ms  count"]
        for k, s in sorted(self.summary().items()):
            lines.append(f"{k:<18} {s['mean_ms']:8.2f} {s['median_ms']:9.2f} "
                         f"{s['max_ms']:7.1f} {s['count']:6d}")
        return "\n".join(lines)
