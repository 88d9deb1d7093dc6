"""Where the frame time goes on the card: torch.profiler over a steady window
of chip_smoke.py's full-width bench scene, synchronous (path A) or pipelined
(path C: --pipeline 4 --frames 160).

    python3 profile_port.py [--frames 60] [--window 20] [--pipeline K] [--out profile_out]
    python3 profile_port.py --ate-spread RUNS [--frames 80] [--pipeline K] [--deterministic]

Records device activity only (CUPTI kernel records; no host-op tracing, so
the host loop runs close to its unprofiled speed). Prints the window's wall
time, the device's busy share (the union of kernel intervals over the
window), device time by kernel (total, launches, per launch), the host
stage timers, and the host syncs per frame: the implicit ones counted with
torch.cuda.set_sync_debug_mode("warn"), by source line, beside the flags
reads (one event wait per frame, K frames late in pipeline mode); writes the
gzipped chrome trace and the full table under --out.

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--window", type=int, default=20,
                    help="profiled frames at the end of the run")
    ap.add_argument("--pipeline", type=int, default=0, metavar="K",
                    help="profile the pipelined tracker (pipeline=K, path C; bench.py's "
                         "warm-up, flush and precompile before the window)")
    ap.add_argument("--out", default="profile_out",
                    help="directory for the trace and the full table")
    ap.add_argument("--ate-spread", type=int, default=0, metavar="RUNS",
                    help="measure path A's ATE over RUNS runs per attention instead")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic torch algorithms where they exist; prints the ops "
                         "that have none (alone: path A once, with a census of the ops "
                         "the switch reroutes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"   # before cuBLAS starts
        torch.use_deterministic_algorithms(True, warn_only=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    cs.phase_build()
    scene = cs.PathA(dev, args.frames)
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
    slam = scene.new_slam(pipeline=args.pipeline)
    start = args.frames - args.window
    for i in range(start):
        scene.step(slam, i)
    if args.pipeline:
        slam.flush()           # bench.py's warm-up ends so
        slam.precompile()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(start, args.frames):
                    scene.step(slam, i)
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
    out = {"pipeline": args.pipeline, "frames": args.frames,
           "frames_profiled": args.window, "wall_ms": wall_us / 1e3,
           "ms_per_frame": wall_us / 1e3 / args.window,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
           "device_kernel_ms_total": dev_total / 1e3,
           "n_kf": slam.n_kf,
           "host_syncs_per_frame": sum(sync_sites.values()) / args.window,
           "host_sync_sites": dict(sync_sites.most_common(12)),
           "flags_reads_per_frame": len(slam.timers.samples.get("flags_fetch", [])) / args.frames,
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()},
           "top_kernels": [{"name": k[:90], "ms": t / 1e3, "count": c,
                            "ms_per_launch": t / 1e3 / c,
                            "share_of_device": t / max(dev_total, 1e-9)}
                           for k, t, c in rows[:20]]}
    os.makedirs(args.out, exist_ok=True)
    tag = f"_p{args.pipeline}" if args.pipeline else ""
    trace = os.path.join(args.out, f"profile_port{tag}_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        dst.write(src.read())
    os.remove(trace)
    with open(os.path.join(args.out, f"profile_port{tag}_table.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
    print(json.dumps(out, indent=1))
    os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")


if __name__ == "__main__":
    main()
