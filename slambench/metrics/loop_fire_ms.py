"""loop_fire_ms: latency of the first unprofiled frame of the window on
which a loop closed (the system's loop-event count rose), in ms."""
from slambench.record import unprofiled


def read(rec: dict):
    return next((f["ms"] for f in unprofiled(rec) if f["loop_rose"]), None)
