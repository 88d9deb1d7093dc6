"""pose_opt_ms: the program's "pose_opt" span (optim/pose_opt.py's
pose_optimization; the tracker calls it on the motion model, the reference
keyframe and the local map): the median over the window's unprofiled frames
of each frame's summed pose_opt samples, in ms. Host-inclusive and unsynced,
as track_ms: the enqueue plus the implicit syncs inside it."""
import numpy as np

from slambench.record import unprofiled


def read(rec: dict):
    ms = [sum(f["stages"]["pose_opt"]) for f in unprofiled(rec)
          if (f["stages"] or {}).get("pose_opt")]
    return float(np.median(ms)) if ms else None
