"""Where path A's frame time goes on the card: torch.profiler over a steady
window of chip_smoke.py's full-width bench scene.

    python3 profile_port.py [--frames 60] [--window 20] [--out profile_out]

Records device activity only (CUPTI kernel records; no host-op tracing, so
the host loop runs close to its unprofiled speed). Prints the window's wall
time, the device's busy share (the union of kernel intervals over the
window), device time by kernel, and the host stage timers; writes the
gzipped chrome trace and the full table under --out. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time

import torch


def _busy_us(events) -> float:
    """Union of the device kernel intervals (overlaps counted once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--window", type=int, default=20,
                    help="profiled frames at the end of the run")
    ap.add_argument("--out", default="profile_out",
                    help="directory for the trace and the full table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    cs.phase_build()
    scene = cs.PathA(dev, args.frames)
    scene.warm_up()
    slam = scene.new_slam()
    start = args.frames - args.window
    for i in range(start):
        scene.step(slam, i)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(start, args.frames):
            scene.step(slam, i)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = _busy_us(events)
    ka = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in ka
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    dev_total = sum(r[1] for r in rows)
    out = {"frames_profiled": args.window, "wall_ms": wall_us / 1e3,
           "ms_per_frame": wall_us / 1e3 / args.window,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernel_ms_total": dev_total / 1e3,
           "n_kf": slam.n_kf,
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()},
           "top_kernels": [{"name": k[:90], "ms": t / 1e3, "count": c,
                            "share_of_device": t / max(dev_total, 1e-9)}
                           for k, t, c in rows[:20]]}
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "profile_port_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        dst.write(src.read())
    os.remove(trace)
    with open(os.path.join(args.out, "profile_port_table.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(out, indent=1))
    os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")


if __name__ == "__main__":
    main()
