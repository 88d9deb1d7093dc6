"""Where the frame time goes on the card: torch.profiler over a steady window
of chip_smoke.py's full-width bench scene, synchronous (path A) or pipelined
(path C: --pipeline 4 --frames 160), over path E's fired loop, or over the
monocular-inertial system of path G (--inertial).

    python3 profile_port.py [--frames 60] [--window 20] [--pipeline K] [--out profile_out]
    python3 profile_port.py --loop --pipeline 4 --frames 160 [--out profile_out]
    python3 profile_port.py --inertial --frames 160 --window 40 [--pipeline K]
    python3 profile_port.py --read-trace profile_out/profile_port_p4_loop_trace.json.gz
    python3 profile_port.py --ate-spread RUNS [--frames 80] [--pipeline K] [--deterministic]

Records device activity only (CUPTI kernel records; no host-op tracing, so
the host loop runs close to its unprofiled speed). Prints the window's wall
time, the device's busy share (the union of kernel intervals over the
window), device time by kernel (total, launches, per launch), the host
stage timers, and the host syncs per frame: the implicit ones counted with
torch.cuda.set_sync_debug_mode("warn"), by source line, beside the flags
reads (one event wait per frame, K frames late in pipeline mode); writes the
gzipped chrome trace and the full table under --out.

With --loop the system is path E's (bench.py with its loop closer). A first
run, unprofiled, finds the frame whose finish fires the loop (runs repeat to
the bit, so the second run fires at the same frame); the second run is
profiled from two frames before that frame through the frames whose polls
run the deferred global-BA chunks (LoopConfig.gba_iters chunks of
gba_chunk_iters iterations), plus two, and the final flush. Its output adds
`loop_breakdown` (see loop_trace_breakdown), which --read-trace prints again
from the trace file alone, without a device.

With --inertial the scene and system are path G's (chip_smoke.PathG: the
IMU samples fed before each frame, loop closing on); the window is the last
--window frames, after the IMU init. The output adds `preintegration`: one
frame's IMU window (its samples) preintegrated alone under the profiler,
with its kernel launches and device time.

With --ate-spread, it measures instead path A's trajectory error (path C's
with --pipeline 4 --frames 160), RUNS runs through fresh systems for each
attention swapped into LightGlue, in turns; one line per run and a summary
per attention:
  kernel     the kernel as built (P as two bf16 terms);
  kernel_p1  the kernel built with FLASH_P_TERMS=1 (P rounded to bf16 once,
             the TPU kernel's arithmetic);
  plain      masked_attention_plain (scores and P rounded to bf16, the JAX
             package's XLA path);
  plain_f32p chip_smoke.masked_attention_f32p (scores and P in f32).
With --deterministic, torch takes its deterministic algorithms where it has
them and the ops that have none are printed at the end. Alone (without
--ate-spread), --deterministic runs path A once that way and prints, beside
the ops that warned, how often the path called each op that torch runs by
another algorithm under that switch (scatter-type and index ops, medians,
segment sums), by name and dtype. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import gzip
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

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


def _single_rounding_lib():
    """csrc/flash_attention.cu built with FLASH_P_TERMS=1 into _build/."""
    from rover_slam_tpu_torch.ops import _build
    src, so = _build._target("flash_attention")
    so = so[:-len(".so")] + "-p1.so"
    if not os.path.exists(so):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_P_TERMS=1",
                        "-o", so, src], check=True, capture_output=True)
    return ctypes.CDLL(so)


def ate_spread(cs, scene, runs: int, pipeline: int = 0):
    from rover_slam_tpu_torch.models import lightglue as lgm
    from rover_slam_tpu_torch.ops import _build, flash_attention as fa

    libs = {"kernel": _build.load("flash_attention"), "kernel_p1": _single_rounding_lib()}
    attention = {"kernel": fa.masked_attention, "kernel_p1": fa.masked_attention,
                 "plain": fa.masked_attention_plain,
                 "plain_f32p": cs.masked_attention_f32p}
    ate = {name: [] for name in attention}
    try:
        for _ in range(runs):
            for name, fn in attention.items():
                lgm.masked_attention = fn
                _build._libs["flash_attention"] = libs.get(name, libs["kernel"])
                r = (cs.run_path_c(scene, count_syncs=False, pipeline=pipeline)
                     if pipeline else cs.run_path_a(scene))
                ate[name].append(r["ate_cm"])
                print(json.dumps({"attention": name, "ate_cm": r["ate_cm"],
                                  "frac_tracked": r["frac_tracked"], "n_kf": r["n_kf"],
                                  "n_lm": r["n_lm"], "launches": r["launches"],
                                  "fps": r["fps"]}), flush=True)
    finally:
        lgm.masked_attention = fa.masked_attention
        _build._libs["flash_attention"] = libs["kernel"]
    for name, v in ate.items():
        print(json.dumps({"attention": name, "runs": len(v), "ate_cm_min": min(v),
                          "ate_cm_median": statistics.median(v), "ate_cm_max": max(v)}))


# Name parts of the aten ops that torch.use_deterministic_algorithms reroutes
# or warns about on the card.
CENSUS = ("index_add", "index_put", "scatter", "index_copy", "put_", "index_reduce",
          "bincount", "histc", "kthvalue", "median", "segment_reduce", "cumsum")


def census(cs, scene):
    """Path A once; counts the calls of the ops named in CENSUS."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            if any(c in name for c in CENSUS):
                if "index_put" in name and kwargs.get(
                        "accumulate", len(args) > 3 and bool(args[3])):
                    name += "(accumulate=True)"
                counts[f"{name} {args[0].dtype}"] += 1
            return func(*args, **kwargs)

    with Count():
        r = cs.run_path_a(scene)
    return r, dict(sorted(counts.items()))


WARM = 40      # bench.py's warm-up frames before flush and precompile


def _loop_fire_frame(scene, pipeline: int):
    """The frame index whose step fires path E's first loop (a fresh system
    through bench.py's warm-up and timed frames; the last frame when the loop
    fires in the final flush), or None."""
    slam = scene.new_slam(pipeline=pipeline, loop=True)
    for i in range(len(scene.imgs)):
        if i == WARM and pipeline:
            slam.flush()
            slam.precompile()
        scene.step(slam, i)
        if slam.loop_events:
            return i
    slam.flush()
    return len(scene.imgs) - 1 if slam.loop_events else None


def loop_trace_breakdown(trace_gz: str, pcg_iters: int) -> dict:
    """Path E's loop window read from its chrome trace: `segment_reduce`
    launches by grid size (count, ms, median ms), and the pose graph's
    Gauss-Newton steps. The pose graph's PCG matvec is a cuBLAS gemv over the
    dense [7K, 7K] f32 matrix, so it takes at least 14 µs at K=512 (51 MB at
    3.35 TB/s); its launches come in runs of pcg_iters, one per GN step,
    apart from other gemv launches of that length. The GN steps span the
    first such run's start to the last one's end: launches, busy ms and wall
    ms there, and for the first step its PCG run and the gap after it."""
    with gzip.open(trace_gz, "rt") as f:
        ev = sorted((e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel"), key=lambda e: e["ts"])
    seg = collections.defaultdict(list)
    for e in ev:
        if "segment_reduce" in e["name"]:
            seg[str(e["args"].get("grid"))].append(e["dur"])
    out = {"segment_reduce_by_grid": {
        g: {"launches": len(d), "ms": sum(d) / 1e3, "median_ms": statistics.median(d) / 1e3}
        for g, d in sorted(seg.items(), key=lambda kv: -sum(kv[1]))}}
    by_name = collections.defaultdict(list)
    for e in ev:
        if "gemv" in e["name"] and 14.0 <= e["dur"] < 30.0:
            by_name[e["name"]].append(e)
    runs = []
    for mv in by_name.values():
        cur = []
        for e in mv:
            if cur and e["ts"] - cur[-1]["ts"] > 50e3:     # 50 ms apart: another run
                runs.append(cur)
                cur = []
            cur.append(e)
        runs.append(cur)
    runs = sorted((r for r in runs if len(r) == pcg_iters), key=lambda r: r[0]["ts"])
    if not runs:
        return out

    def span(a, b):
        ins = [e for e in ev if a <= e["ts"] and e["ts"] + e["dur"] <= b]
        return {"wall_ms": (b - a) / 1e3, "launches": len(ins),
                "busy_ms": sum(e["dur"] for e in ins) / 1e3}

    first_end = runs[0][-1]["ts"] + runs[0][-1]["dur"]
    out["pose_graph"] = {
        "gn_steps": len(runs), "pcg_iters": pcg_iters,
        "all_steps": span(runs[0][0]["ts"], runs[-1][-1]["ts"] + runs[-1][-1]["dur"]),
        "first_pcg": span(runs[0][0]["ts"], first_end),
        "between_first_two": span(first_end, runs[1][0]["ts"]) if len(runs) > 1 else None,
        "matvec_median_us": statistics.median(e["dur"] for r in runs for e in r)}
    return out


def preint_census(scene, slam) -> dict:
    """The last frame's IMU window through the system's own preintegration,
    alone under the profiler: its samples, kernel launches and device ms."""
    from torch.profiler import ProfilerActivity, profile
    acc, gyro, t = scene.imu[-1]
    slam._imu_buf = [(a, g, float(s)) for a, g, s in zip(acc, gyro, t)]
    slam._last_frame_time = float(t[0]) - float(t[1] - t[0])   # one sample period
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        slam._preintegrate_window()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"samples": len(t), "launches": len(kernels),
            "device_ms": sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--window", type=int, default=20,
                    help="profiled frames at the end of the run")
    ap.add_argument("--pipeline", type=int, default=0, metavar="K",
                    help="profile the pipelined tracker (pipeline=K, path C; bench.py's "
                         "warm-up, flush and precompile before the window)")
    ap.add_argument("--loop", action="store_true",
                    help="path E's loop closer on; the window covers the fired loop and "
                         "the global-BA chunks after it")
    ap.add_argument("--inertial", action="store_true",
                    help="path G: the monocular-inertial system on the IMU orbit")
    ap.add_argument("--read-trace", default=None, metavar="TRACE_GZ",
                    help="print the --loop breakdown of a trace a --loop run wrote, and stop "
                         "(needs no device)")
    ap.add_argument("--out", default="profile_out",
                    help="directory for the trace and the full table")
    ap.add_argument("--ate-spread", type=int, default=0, metavar="RUNS",
                    help="measure path A's ATE over RUNS runs per attention instead")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic torch algorithms where they exist; prints the ops "
                         "that have none (alone: path A once, with a census of the ops "
                         "the switch reroutes)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    pcg_iters = max(48, cs.PathA.K // 2)   # optimize_essential_graph's default at the bench K
    if args.read_trace:
        print(json.dumps(loop_trace_breakdown(args.read_trace, pcg_iters), indent=1))
        return
    if not torch.cuda.is_available():
        print("profile_port.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # before cuBLAS starts
        torch.use_deterministic_algorithms(True, warn_only=True)
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    cs.phase_build()
    scene = cs.PathG(dev, args.frames) if args.inertial else cs.PathA(dev, args.frames)
    if args.deterministic and not args.ate_spread:
        warned = set()

        def note_all(message, *_a, **_k):
            if "determinis" in str(message):
                warned.add(str(message).split(" does not have")[0][:200])

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note_all
            r, counts = census(cs, scene)
        print(json.dumps({"ate_cm": r["ate_cm"], "trajectory_digest": r.get("trajectory_digest"),
                          "warned": sorted(warned), "calls": counts}, indent=1))
        os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
        return
    if args.ate_spread:
        nondet = set()

        def note(message, *_a, **_k):
            if "does not have a deterministic" in str(message):
                nondet.add(str(message).split(" does not have")[0])

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            ate_spread(cs, scene, args.ate_spread, args.pipeline)
        if args.deterministic:
            print(json.dumps({"ops_without_deterministic_algorithm": sorted(nondet)}))
        os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
        return
    scene.warm_up()
    start, end = args.frames - args.window, args.frames
    fire = None
    if args.loop:
        fire = _loop_fire_frame(scene, args.pipeline)
        if fire is None:
            print(json.dumps({"loop": "no loop fired in the scene"}))
            sys.exit(1)
        lc_cfg = scene.new_slam(pipeline=args.pipeline, loop=True).loop_closer.cfg
        chunks = -(-lc_cfg.gba_iters // max(lc_cfg.gba_chunk_iters, 1))
        start, end = max(fire - 2, WARM), min(fire + chunks + 2, args.frames)
    window = end - start
    slam = scene.new_slam(pipeline=args.pipeline, loop=args.loop or args.inertial)
    fire_frames = []

    def step(i):
        n_loops = len(getattr(slam, "loop_events", []))
        scene.step(slam, i)
        if len(getattr(slam, "loop_events", [])) > n_loops:
            fire_frames.append(i)

    warm = min(start, WARM) if args.pipeline else start
    for i in range(warm):
        step(i)
    if args.pipeline:
        slam.flush()           # bench.py's warm-up ends so
        slam.precompile()
    for i in range(warm, start):
        step(i)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(start, end):
                    step(i)
                slam.flush()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync_sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    events = prof.events()
    busy = _busy_us(events)
    ka = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in ka
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    dev_total = sum(r[1] for r in rows)
    out = {"pipeline": args.pipeline, "frames": args.frames, "loop": args.loop,
           "window": [start, end], "loop_fired_at_frame": fire,
           "loop_events": [(kf, {k: v for k, v in info.items() if k != "loop"})
                           for kf, info in getattr(slam, "loop_events", [])],
           "frames_profiled": window, "wall_ms": wall_us / 1e3,
           "ms_per_frame": wall_us / 1e3 / window,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernel_ms_total": dev_total / 1e3,
           "n_kf": slam.n_kf,
           "host_syncs_per_frame": sum(sync_sites.values()) / window,
           "host_sync_sites": dict(sync_sites.most_common(12)),
           "flags_reads_per_frame": len(slam.timers.samples.get("flags_fetch", [])) / args.frames,
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()},
           "top_kernels": [{"name": k[:90], "ms": t / 1e3, "count": c,
                            "ms_per_launch": t / 1e3 / c,
                            "share_of_device": t / max(dev_total, 1e-9)}
                           for k, t, c in rows[:20]]}
    os.makedirs(args.out, exist_ok=True)
    tag = (f"_p{args.pipeline}" if args.pipeline else "") + ("_loop" if args.loop else "")
    trace = os.path.join(args.out, f"profile_port{tag}_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        dst.write(src.read())
    os.remove(trace)
    with open(os.path.join(args.out, f"profile_port{tag}_table.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
    if args.loop:
        out["loop_breakdown"] = loop_trace_breakdown(trace + ".gz", pcg_iters)
    if args.inertial:
        out["imu_ready"] = slam.imu_ready
        out["scale_log"] = slam.scale_log
        out["loop_fire_frames"] = fire_frames
        out["stage_count"] = {k: v["count"] for k, v in slam.timers.summary().items()}
        out["preintegration"] = preint_census(scene, slam)
    print(json.dumps(out, indent=1))
    os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")


if __name__ == "__main__":
    main()
