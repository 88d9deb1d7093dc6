"""fps_unprofiled: frames per second over the traced run's window up to its
traced stretch: the unprofiled frames over the time from the window's start
to the end of the last of them, so every insert and loop fire in that time
counts. The same rate as the end-to-end fps, which no cell holds to a bound
because its runs spread too widely on a shared host (PERF.md section 2)."""
from slambench.record import unprofiled


def read(rec: dict):
    rows = unprofiled(rec)
    return len(rows) / rows[-1]["t_s"] if len(rows) >= 10 else None
