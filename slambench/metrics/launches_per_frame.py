"""launches_per_frame: device kernels (copies and memsets left out) the
traced stretch ran, per frame of the stretch."""
from slambench.record import per_stretch_frame


def read(rec: dict):
    return per_stretch_frame(rec, rec["trace"]["kernels"]) if rec["trace"]["kernels"] else None
