"""insert_frame_ms: median latency of the window's unprofiled frames on
which the system's keyframe count rose (the benchmark's frame clock), in
ms."""
import numpy as np

from slambench.record import unprofiled


def read(rec: dict):
    ms = [f["ms"] for f in unprofiled(rec) if f["kf_rose"]]
    return float(np.median(ms)) if ms else None
