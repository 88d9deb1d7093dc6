"""superpoint_ms: device time of the kernels launched inside the
benchmark's "superpoint" range (its SuperPointExtractor call), per frame of
the traced stretch, in ms."""
from slambench.record import per_stretch_frame


def read(rec: dict):
    us = rec["trace"]["range_device_us"].get("superpoint", 0.0)
    return per_stretch_frame(rec, us / 1e3) if us > 0 else None
