"""device_idle_pct: the share of the traced stretch's wall time in which no
kernel or copy ran on the device (1 - busy union / wall), in %."""


def read(rec: dict):
    t = rec["trace"]
    if t["wall_s"] <= 0 or t["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / 1e6 / t["wall_s"])
