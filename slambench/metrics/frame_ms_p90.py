"""frame_ms_p90: 90th percentile latency of the window's unprofiled frames
(those before the traced stretch) in the traced run, in ms: the tail that
inserts and the loop's fire make. A per-layer metric with no bound: it
swings by 10-25 % between runs of one seed (PERF.md section 2)."""
import numpy as np

from slambench.record import unprofiled


def read(rec: dict):
    ms = [f["ms"] for f in unprofiled(rec)]
    return float(np.percentile(ms, 90)) if len(ms) >= 10 else None
