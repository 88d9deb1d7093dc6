"""lightglue_ms: device time of the kernels launched inside the benchmark's
"lightglue" range (its proxy around the matcher's calls), per frame of the
traced stretch, in ms."""
from slambench.record import per_stretch_frame


def read(rec: dict):
    us = rec["trace"]["range_device_us"].get("lightglue", 0.0)
    return per_stretch_frame(rec, us / 1e3) if us > 0 else None
