"""local_ba_ms: the keyframe insert's windowed local BA (the program's
"insert.local_ba" span: _covis_window, then _local_ba_body on optim/ba.py):
median of its samples over the window's unprofiled frames, in ms.
Host-inclusive and unsynced, as track_ms."""
from slambench.record import stage_median_ms


def read(rec: dict):
    return stage_median_ms(rec, "insert.local_ba")
