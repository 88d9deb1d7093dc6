"""track_ms: median of the StageTimers stage lm_track (slam/tracking.py's
track, fused with the map update under pipelining) over the window's
unprofiled frames of the traced run, in ms. Host-inclusive and unsynced: it
counts the enqueue and the implicit syncs inside the stage."""
from slambench.record import stage_median_ms


def read(rec: dict):
    return stage_median_ms(rec, "lm_track")
