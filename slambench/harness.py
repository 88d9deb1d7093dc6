"""The benchmark's runner: one run of one cell of BENCHMARK.json.

A cell names a configuration (slambench/configs/<config>.json, which names
its system, slambench/systems/<system>.py) and a traffic mix
(slambench/traffic/<traffic>.json, which names its scene generator,
slambench/scenes/<generator>.py). Per-layer metrics are readers,
slambench/metrics/<metric>.py. Everything is found by name, so a new cell,
configuration, traffic mix or metric is new files and new entries.

Hooks a new configuration fills with new files alone:
- a system module may set SAMPLE_P = {kind: probability}: sample kinds that
  Capture draws beside its own (superpoint, lightglue, nn), kept with
  cap.keep(kind, ...) for the checks;
- a configuration may list "checks": [name, ...]: judges,
  slambench/judges/<name>.py, each returning numbers that checks.judge holds
  against the configuration's limits;
- a traffic file may hold "guarantees" with loops_min and loops_max alone,
  which take the place of the configuration's loops_min in the
  configuration the cell runs (Cell.config; a route decides whether a loop
  can close);
- a generator's render(i) may return [E, H, W], E images a frame (a stereo
  pair): the frames are then [F, E, H, W] and the record's
  images_per_frame is E.

A run: make the traffic's route and the seed's scene on it (where the route
starts), load the route's rendered frames (uint8, on the host, as a camera
hands them over), build the system, run the traffic's warm-up frames, then
the measured window: frames sent one after the other (a closed loop: each
frame is sent when the previous one has returned; it copies its image to the
device, runs the system and ends with a device synchronize) until --seconds
have passed. With --trace 1 the window's last trace_tail_s seconds (the
traffic's; at least MIN_TRACED frames) run under torch.profiler and the sync
counter, so that the profiler's cost and its stop fall after the frames the
other per-layer metrics read; the per-layer metrics are read from the record
that run writes. After the window the system is flushed, the memory peak
read, the system freed, and the outputs the window produced are judged
against the plain reference (checks.py).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import json
import os
import random
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rover_slam_tpu")
MIN_TRACED = 3     # frames the traced stretch holds at least; a traced window waits for them


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cache_dir(root: str) -> str:
    """The benchmark's fixed cache directory inside the checkout."""
    return os.path.join(root, ".slambench_cache")


def set_cache_env(root: str):
    """Every build and kernel cache under the checkout, at fixed paths."""
    base = cache_dir(root)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic mix and
    metric entries resolved by name."""

    def __init__(self, root: str, workload: str):
        self.root = root
        self.manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"slambench: no workload {workload!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.entry = cells[workload]
        self.name = workload
        cfg_entry = {c["name"]: c for c in self.manifest["configs"]}[self.entry["config"]]
        config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic_name = self.entry["traffic"]
        self.traffic = load_json(os.path.join(HERE, "traffic", f"{self.traffic_name}.json"))
        # the configuration as this cell runs it: the traffic's loop counts in
        # place of its own
        self.config = dict(config, guarantees=route_guarantees(config, self.traffic,
                                                                self.traffic_name))
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if name_in(workload, m.get("workloads"))]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if name_in(workload, m.get("workloads"))]

    def module(self, kind: str, name: str):
        return importlib.import_module(f"slambench.{kind}.{name}")


def name_in(name: str, names) -> bool:
    return names is None or name in names


ROUTE_GUARANTEES = ("loops_min", "loops_max")


def route_guarantees(config: dict, traffic: dict, traffic_name: str) -> dict:
    """The configuration's guarantees with the traffic's "guarantees" in
    place of its loop count: a traffic may state loops_min and loops_max
    and nothing else (tracked_min and the ATE limit are the
    configuration's)."""
    route = traffic.get("guarantees", {})
    bad = sorted(set(route) - set(ROUTE_GUARANTEES))
    if bad:
        raise SystemExit(f"slambench: traffic {traffic_name!r} states guarantees {bad}; a "
                         f"traffic may state only {list(ROUTE_GUARANTEES)}")
    return {**config["guarantees"], **route}


# --- frames --------------------------------------------------------------------

def load_frames(cell: Cell, scene_mod, route) -> np.ndarray:
    """The route's rendered uint8 frames [F, H, W] ([F, E, H, W] where a
    frame is E images), from the render cache when it holds them (keyed by
    what they depend on: the traffic's world and route, the camera and the
    generator's source; not the seed)."""
    with open(scene_mod.__file__, "rb") as f:
        src = hashlib.sha256(f.read()).hexdigest()
    key = json.dumps({"scene": scene_mod.frame_key(cell.traffic, cell.config), "src": src},
                     sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:20]
    path = os.path.join(cache_dir(cell.root), "frames", f"{cell.traffic_name}-{digest}.npy")
    if os.path.exists(path):
        frames = np.load(path)
        if frames.shape[0] == len(route.times):
            return frames
    t = time.perf_counter()
    frames = np.stack([route.render(i) for i in range(len(route.times))])
    log(f"# rendered {len(frames)} frames in {time.perf_counter() - t:.1f} s")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    part = path + ".part"
    with open(part, "wb") as f:
        np.save(f, frames)
    os.replace(part, path)
    return frames


# --- what the window produces, captured for the checks and the trace ----------

class Capture:
    """The benchmark's own spans, proxies and samples.

    span(name): a torch.profiler range in a traced run (nothing otherwise).
    The matcher proxy and the B2 recorder note the shapes of every call and
    keep, for calls drawn from the seed while the window is open, copies of
    their inputs and outputs; the systems note SuperPoint's outputs the same
    way. Draws: each event of a kind is
    kept with probability SAMPLE_P[kind] until SAMPLE_MAX are kept. A system
    module's own SAMPLE_P (system_p) adds its kinds to these; it may not
    change theirs."""

    SAMPLE_P = {"superpoint": 0.12, "lightglue": 0.12, "nn": 0.1}
    SAMPLE_MAX = 16

    def __init__(self, seed: int, traced: bool, system_p: dict = None):
        system_p = dict(system_p or {})
        clash = sorted(set(system_p) & set(self.SAMPLE_P))
        if clash:
            raise SystemExit(f"slambench: a system's SAMPLE_P redeclares the harness's sample "
                             f"kinds {clash}")
        self.sample_p = {**self.SAMPLE_P, **system_p}
        self.rng = random.Random(int(seed) * 7919 + 17)
        self.traced = traced
        self.in_window = False
        self.frame = -1
        self.profiling = False
        self.lightglue_calls = []   # (frame, b, n, m, profiling)
        self.nn_calls = []          # (frame, n0, n1, d, profiling)
        self.samples = {k: [] for k in self.sample_p}
        self.batched_kept = False

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def draw(self, kind: str, force: bool = False) -> bool:
        """Whether to keep this event: one draw per event in the window; the
        first event of each kind is kept, and a forced one may take one place
        beyond SAMPLE_MAX."""
        if not self.in_window:
            return False
        hit = self.rng.random() < self.sample_p[kind]
        n = len(self.samples[kind])
        return ((force or n == 0) and n <= self.SAMPLE_MAX) or (hit and n < self.SAMPLE_MAX)

    def keep(self, kind: str, **item):
        item["frame"] = self.frame
        self.samples[kind].append(item)


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


class MatcherProxy:
    """Stands between the system and its LightGlue frame matcher: notes
    (B, N, M) of every call, opens the "lightglue" range, and keeps the
    sampled calls' inputs and matches. The first batched call (B > 1) of the
    window is always kept."""

    def __init__(self, inner, cap: Capture):
        self.inner, self.cap = inner, cap

    def _note(self, b, n, m, args, out, batched):
        cap = self.cap
        if cap.in_window:
            cap.lightglue_calls.append((cap.frame, b, n, m, cap.profiling))
        force = batched and not cap.batched_kept
        if cap.draw("lightglue", force=force):
            cap.batched_kept |= batched
            cap.keep("lightglue", args=[_clone(a) for a in args], matches=_clone(out),
                     batched=batched)

    def __call__(self, kpts0, desc0, valid0, kpts1, desc1, valid1):
        with self.cap.span("lightglue"):
            out = self.inner(kpts0, desc0, valid0, kpts1, desc1, valid1)
        self._note(1, kpts0.shape[0], kpts1.shape[0],
                   [a[None] for a in (kpts0, desc0, valid0, kpts1, desc1, valid1)],
                   out[None], False)
        return out

    def match_batch(self, kpts0, desc0, valid0, kpts1, desc1, valid1):
        with self.cap.span("lightglue"):
            out = self.inner.match_batch(kpts0, desc0, valid0, kpts1, desc1, valid1)
        self._note(kpts0.shape[0], kpts0.shape[1], kpts1.shape[1],
                   [kpts0, desc0, valid0, kpts1, desc1, valid1], out, kpts0.shape[0] > 1)
        return out


@contextlib.contextmanager
def recording_nn(cap: Capture):
    """Wraps the port's B2 reduce (rover_slam_tpu_torch.ops.nn_matcher
    .nn_reduce, through which every mutual-NN match goes) so that its calls
    are noted and the sampled ones kept; restores it on exit."""
    from rover_slam_tpu_torch.ops import nn_matcher as nm
    inner = nm.nn_reduce

    def nn_reduce(desc0, desc1, valid1):
        out = inner(desc0, desc1, valid1)
        if cap.in_window:
            cap.nn_calls.append((cap.frame, desc0.shape[0], desc1.shape[0], desc0.shape[1],
                                 cap.profiling))
            if cap.draw("nn"):
                cap.keep("nn", desc0=_clone(desc0), desc1=_clone(desc1), valid1=_clone(valid1),
                         best=_clone(out[0]), idx=_clone(out[1]))
        return out

    nm.nn_reduce = nn_reduce
    try:
        yield
    finally:
        nm.nn_reduce = inner


class SpanTimers:
    """A system's StageTimers with each stage also opened as a profiler
    range "stage:<name>" (traced runs only)."""

    def __init__(self, inner):
        self.inner = inner
        self.samples = inner.samples

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(f"stage:{name}"), self.inner.stage(name):
            yield

    def __getattr__(self, k):
        return getattr(self.inner, k)


# --- the device ----------------------------------------------------------------

def power_limit_w():
    """The card's power limit in W, as nvidia-smi reads it (None if it
    cannot)."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=60)
        return float(smi.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_block(dev, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": peak, "power_limit_w": power_limit_w()}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --- the traced stretch ----------------------------------------------------------

class Tracer:
    """torch.profiler (CPU and CUDA activity) and the implicit host sync
    counter (torch.cuda.set_sync_debug_mode("warn"), counted as the port's
    bench_port.counting_syncs counts them) over the traced stretch."""

    def __init__(self, dev):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.dev = dev
        self.syncs = 0
        self._warn = None
        self.t0 = None

    @staticmethod
    def frames(rows) -> int:
        return sum(1 for r in rows if r["profiled"])

    def start(self):
        sync(self.dev)
        self._warn = warnings.catch_warnings(record=True)
        self.caught = self._warn.__enter__()
        warnings.simplefilter("always")
        if self.dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        sync(self.dev)
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        if self.dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
        self._warn.__exit__(None, None, None)
        self.syncs = sum("synchroniz" in str(w.message) for w in self.caught)


def open_ranges(ranges: list, queries: list) -> list:
    """For each query (thread, t_ns): the names of the profiler ranges open
    on that thread at t_ns, outermost first (a tuple). ranges: (thread,
    start_ns, end_ns, name); the ranges of one thread nest, as
    record_function's do."""
    by_thread: dict = {}
    for th, s0, e0, name in ranges:
        by_thread.setdefault(th, []).append((s0, -e0, name))
    order: dict = {}
    for qi, (th, t) in enumerate(queries):
        order.setdefault(th, []).append((t, qi))
    out = [()] * len(queries)
    for th, qs in order.items():
        rs = sorted(by_thread.get(th, []))
        stack, j, cur = [], 0, ()
        for t, qi in sorted(qs):
            changed = False
            while j < len(rs) and rs[j][0] <= t:
                s0, neg_e, name = rs[j]
                j += 1
                while stack and stack[-1][0] <= s0:
                    stack.pop()
                stack.append((-neg_e, name))
                changed = True
            while stack and stack[-1][0] <= t:
                stack.pop()
                changed = True
            if changed:
                cur = tuple(name for e0, name in stack if e0 > t)
            out[qi] = cur
    return out


def attribute(ranges: list, kernels: list, gaps: list, main_thread) -> dict:
    """Device time and idle time by profiler range, for every range the
    stretch opened: the benchmark's and any the program opens itself.

    kernels: (launch thread, launch t_ns, device us); a kernel belongs to
    the chain of ranges open on its launching thread when its launch ran.
    gaps: (t_ns, us) idle intervals of the device at their midpoints, read
    on main_thread (the thread that runs the frames). Returns, by range name,
    the device time and kernel count of every kernel launched inside it
    (inclusive: a kernel counts for each range that encloses it) and of those
    whose innermost range it is ("self"), the same by the whole chain
    (outermost first, joined by " > "), and the idle time by the innermost
    range and by the chain; "(none)" is outside every range."""
    chains = open_ranges(ranges, [(th, t) for th, t, _ in kernels])
    by_chain: dict = {}
    for chain, (_, _, us) in zip(chains, kernels):
        c = by_chain.setdefault(chain, [0.0, 0])
        c[0] += us
        c[1] += 1
    incl: dict = {}
    self_: dict = {}
    for chain, (us, n) in by_chain.items():
        for name in set(chain) or {"(none)"}:
            c = incl.setdefault(name, [0.0, 0])
            c[0] += us
            c[1] += n
        c = self_.setdefault(chain[-1] if chain else "(none)", [0.0, 0])
        c[0] += us
        c[1] += n
    idle_by: dict = {}
    idle_chain: dict = {}
    for chain, (_, us) in zip(open_ranges(ranges, [(main_thread, t) for t, _ in gaps]), gaps):
        k = chain[-1] if chain else "(none)"
        idle_by[k] = idle_by.get(k, 0.0) + us
        k = " > ".join(chain) or "(none)"
        idle_chain[k] = idle_chain.get(k, 0.0) + us
    return {"range_device_us": {k: v[0] for k, v in incl.items()},
            "range_kernels": {k: v[1] for k, v in incl.items()},
            "range_self_device_us": {k: v[0] for k, v in self_.items()},
            "chain_device_us": {(" > ".join(k) or "(none)"): v[0] for k, v in by_chain.items()},
            "chain_kernels": {(" > ".join(k) or "(none)"): v[1] for k, v in by_chain.items()},
            "idle_us_by_range": idle_by, "idle_us_by_chain": idle_chain}


def _thread(e) -> int:
    return e.start_thread_id() if hasattr(e, "start_thread_id") else 0


def reduce_trace(tracer: Tracer) -> dict:
    """The stretch's device activity from the profiler's raw events: time
    and count by device operation, the busy union of kernel and copy
    intervals, the kernel launches, every profiler range the host opened
    (its count and host time), and device and idle time by range
    (attribute)."""
    t_reduce = time.perf_counter()
    evs = tracer.prof.profiler.kineto_results.events()
    cpu, dev_ev = [], []
    for e in evs:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev_ev.append(e)
        else:
            cpu.append(e)
    ranges = [(_thread(e), e.start_ns(), e.end_ns(), e.name()) for e in cpu
              if e.is_user_annotation()]
    host: dict = {}
    for _, s0, e0, name in ranges:
        h = host.setdefault(name, [0, 0.0])
        h[0] += 1
        h[1] += (e0 - s0) / 1e3
    frame_threads = [r[0] for r in ranges if r[3] == "frame"]
    main_thread = frame_threads[0] if frame_threads else (
        max(set(r[0] for r in ranges), key=[r[0] for r in ranges].count) if ranges else 0)
    launch_at = {e.correlation_id(): (_thread(e), e.start_ns()) for e in cpu if e.correlation_id()}
    ops: dict = {}
    iv, kernels = [], []
    unattributed = 0
    for e in dev_ev:
        name, s0, d = e.name(), e.start_ns(), e.duration_ns()
        o = ops.setdefault(name, [0.0, 0])
        o[0] += d / 1e3
        o[1] += 1
        iv.append((s0, s0 + d))
        if not (name.startswith("Memcpy") or name.startswith("Memset")):
            at = launch_at.get(e.linked_correlation_id()) or launch_at.get(e.correlation_id())
            if at is None:
                unattributed += 1
                at = (None, 0)
            kernels.append((at[0], at[1], d / 1e3))
    iv.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s0, e0 in iv:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy_us += (cur_e - cur_s) / 1e3
                gaps.append(((cur_e + s0) // 2, (s0 - cur_e) / 1e3))
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy_us += (cur_e - cur_s) / 1e3
    out = attribute(ranges, kernels, gaps, main_thread)
    log(f"# trace: {len(evs)} events, {len(dev_ev)} on the device, {len(kernels)} kernels "
        f"({unattributed} with no launch found), {len(ranges)} ranges of {len(host)} names; "
        f"reduced in {time.perf_counter() - t_reduce:.1f} s")
    out.update(device_ops=ops, busy_us=busy_us, kernels=len(kernels), events=len(evs),
               unattributed=unattributed, ranges=host)
    return out


# --- one run -----------------------------------------------------------------------

def stage_lengths(timers) -> dict:
    return {k: len(v) for k, v in timers.samples.items()}


def stage_diff(timers, before: dict) -> dict:
    return {k: list(v[before.get(k, 0):]) for k, v in timers.samples.items()
            if len(v) > before.get(k, 0)}


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device=None, root: str = ROOT, control: bool = False) -> tuple:
    """One run of a cell. Returns (exit code, result dict or None). device
    None is the card: a run finds no card, or fewer than the cell asks for,
    fails. The CPU is for the tests' tiny dry runs only."""
    from slambench import checks
    cell = Cell(root, workload)
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"slambench: needs {chips} CUDA device(s); torch.cuda.is_available()="
                f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
            return 2, None
        dev = torch.device("cuda", 0)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    scene_mod = cell.module("scenes", traffic["generator"])
    route = scene_mod.make_route(traffic, cfg)
    scene = scene_mod.for_seed(route, traffic, seed)
    frames_u8 = load_frames(cell, scene_mod, route)[scene.first:scene.first + len(scene.times)]
    from slambench.reference.weights import load_npz
    trees = {k: load_npz(os.path.join(root, p)) for k, p in cfg["weights"].items()}
    system_mod = cell.module("systems", cfg["system"])
    cap = Capture(seed, trace, getattr(system_mod, "SAMPLE_P", None))
    system = system_mod.System(cfg, scene, frames_u8, trees, dev, cap)
    n_frames = frames_u8.shape[0]
    warm = int(traffic["warm_frames"])
    tail_s = float(traffic["trace_tail_s"])     # the traced stretch: the window's last seconds
    with recording_nn(cap):
        system.warm_up()
        for i in range(warm):
            cap.frame = i
            system.frame(i)
        system.before_window()
        if trace:
            system.slam.timers = SpanTimers(system.slam.timers)
        timers = system.slam.timers
        stages_before = stage_lengths(timers)
        n_loops0 = len(system.slam.loop_events)
        sync(dev)
        setup_s = time.perf_counter() - t_process
        log(f"# {workload} seed {seed}: set-up {setup_s:.2f} s, route frames from "
            f"{scene.first}, window from frame {warm}")
        tracer = Tracer(dev) if trace else None
        rows, raised = [], 0
        cap.in_window = True
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i, t_end = warm, t0
        while True:
            k = i - warm
            if i >= n_frames:
                raise RuntimeError(f"{workload}: the window outran its {n_frames} frames "
                                   f"({k} frames in {t_end - t0:.1f} s)")
            if tracer is not None and tracer.t0 is None and t_end >= deadline - tail_s:
                tracer.start()
                cap.profiling = True
            st_before = stage_lengths(timers) if trace else None
            n_kf0 = system.slam.n_kf
            n_l0 = len(system.slam.loop_events)
            cap.frame = i
            t1 = time.perf_counter()
            try:
                with cap.span("frame"):
                    system.frame(i)
            except Exception:   # a frame that raised counts as failed; the run goes on
                raised += 1
                log(f"# frame {i} raised:\n{traceback.format_exc()}")
            t_end = time.perf_counter()
            rows.append({"i": i, "ms": (t_end - t1) * 1e3, "t_s": t_end - t0,
                         "profiled": cap.profiling,
                         "kf_rose": system.slam.n_kf > n_kf0,
                         "loop_rose": len(system.slam.loop_events) > n_l0,
                         "stages": stage_diff(timers, st_before) if trace else None})
            i += 1
            if t_end >= deadline and (tracer is None or tracer.frames(rows) >= MIN_TRACED):
                break
        if tracer is not None and cap.profiling:
            tracer.stop()
            cap.profiling = False
        window_s = t_end - t0
        cap.in_window = False
        n_loops_window = len(system.slam.loop_events) - n_loops0
        window_stages = stage_diff(timers, stages_before)
        system.after_window()
    sync(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    outcome = system.outcome([r["i"] for r in rows], n_loops_window)
    record = None
    if trace:
        record = build_record(cell, scene, rows, cap, tracer, window_stages,
                              frames_u8.shape[1] if frames_u8.ndim == 4 else 1)
    system.release()
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged = checks.judge(cfg, scene, cap, trees, dev, outcome, control=control)
    correct = all(c["ok"] for c in judged["checks"].values())
    failed = sum(1 for s in outcome["states_ok"] if not s) + raised
    res = {"correct": bool(correct), "attempted": len(rows), "failed": int(failed)}
    if trace:
        res["metrics"] = per_layer_metrics(cell, record)
        dev_blk = device_block(dev, chips, peak)
        dev_blk["busy_s"] = record["trace"]["busy_us"] / 1e6
        dev_blk["window_s"] = record["trace"]["wall_s"]
        res["device"] = dev_blk
        res["breakdown"] = breakdown(record)
    else:
        ms = np.asarray([r["ms"] for r in rows])
        # every end-to-end metric the harness can take; a cell reports those
        # BENCHMARK.json gives it
        e2e = {"fps": len(rows) / window_s, "frame_ms_median": float(np.median(ms)),
               "setup_s": setup_s}
        res["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
        res["device"] = device_block(dev, chips, peak)
    log(f"# frames {len(rows)} in {window_s:.3f} s; outcome " + json.dumps(outcome["summary"]))
    if control:
        res["control"] = judged["control"]
    res["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in judged["checks"].items()}
    for k, c in judged["checks"].items():
        log(f"check {k} {c['value']!r} {c['op']} {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}")
    return 0, res


def build_record(cell, scene, rows, cap, tracer, window_stages, images_per_frame: int) -> dict:
    """The traced run's record, which every per-layer metric reads: one
    image's size (the scene's) and the images a frame."""
    t = reduce_trace(tracer)
    t["wall_s"] = tracer.wall_s
    t["frames"] = sum(1 for r in rows if r["profiled"])
    t["syncs"] = tracer.syncs
    return {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
            "image_hw": list(scene.image_hw), "images_per_frame": int(images_per_frame),
            "frames": rows, "stages": window_stages,
            "lightglue_calls": cap.lightglue_calls, "nn_calls": cap.nn_calls, "trace": t}


def per_layer_metrics(cell: Cell, record: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        v = cell.module("metrics", m["name"]).read(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(record: dict) -> dict:
    t = record["trace"]
    ops = sorted(t["device_ops"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(t["idle_us_by_range"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:160], v[0] / 1e6] for k, v in ops],
            "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


def main(argv=None, t_process: float = None, device=None) -> int:
    p = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_process = time.perf_counter() if t_process is None else t_process
    with contextlib.redirect_stdout(sys.stderr):
        code, res = run(args.workload, args.seed, args.seconds, bool(args.trace), t_process,
                        device=device)
    if code != 0:
        return code
    bad = forbidden_modules()
    if bad:
        log(f"slambench: modules of {FORBIDDEN} were loaded: {bad}")
        return 3
    print(json.dumps(res), flush=True)
    return 0
