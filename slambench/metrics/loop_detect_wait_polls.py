"""loop_detect_wait_polls: how long a keyframe's place-recognition pack waits
in the loop closer's queue (slam/loop_closing.py, _pending_detect): the mean
of the program's "loop.detect_wait" samples over the window, each the number
of per-frame polls between a detection's dispatch and the read of its
pack."""
import numpy as np


def read(rec: dict):
    polls = rec["stages"].get("loop.detect_wait", [])
    return float(np.mean(polls)) if polls else None
