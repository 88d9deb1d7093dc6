"""The port's spans and counters (utils/profiling.py): what a span costs and
keeps with no profiler, the ranges and nesting a short CPU MonocularSLAM run
shows under torch.profiler, implicit syncs counted by innermost span beside
the caller's own warning record, the loop closer's samples reaching a
wrapped StageTimers, the counter registry, and the benchmark's readers of
these samples (slambench/metrics/) on a hand-made record."""
import importlib
import time
import warnings

import pytest
import torch

import torch_parity
from rover_slam_tpu_torch.models.lightglue import LightGlueMatcher
from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor
from rover_slam_tpu_torch.slam import tracking as T
from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
from rover_slam_tpu_torch.slam.system import MonocularSLAM
from rover_slam_tpu_torch.utils import profiling
from rover_slam_tpu_torch.utils.timing import StageTimers

SYNC = "called a synchronizing CUDA operation"   # torch's sync debug warning


def _no_ranges(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range was opened for {name} with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_with_no_profiler_opens_no_range_and_keeps_only_sinked_samples(monkeypatch):
    _no_ranges(monkeypatch)
    assert profiling.span("track.match") is profiling.span("b1.attention", sample=False)
    timers = StageTimers()
    with timers.stage("lm_track"):          # its own sink, with or without a frame
        with profiling.span("track.match"):
            pass
    assert list(timers.samples) == ["lm_track"] and len(timers.samples["lm_track"]) == 1
    frame = StageTimers()
    with profiling.frame_sink(frame.samples):
        with timers.stage("lm_track"), profiling.span("track.motion"):
            with profiling.span("b1.attention", sample=False):
                profiling.sample("loop.detect_wait", 3)
    assert sorted(frame.samples) == ["loop.detect_wait", "track.motion"]
    assert frame.samples["loop.detect_wait"] == [3] and len(timers.samples["lm_track"]) == 2
    assert not any(k.endswith("/syncs") for k in frame.samples)
    profiling.sample("loop.detect_wait", 4)   # no frame: dropped
    assert frame.samples["loop.detect_wait"] == [3]


def test_counter_registry():
    saved = profiling.snapshot_counters()
    try:
        profiling.reset_counters()
        profiling.count("attention_launches")
        profiling.count("launches_by_batch", 3)
        profiling.count("launches_by_batch", 3)
        profiling.count("launches_by_shape", "8x8x64", n=2)
        assert profiling.counter("attention_launches") == 1
        assert profiling.counter_by("launches_by_batch") == {3: 2}
        assert profiling.counter("launches_by_shape") == 2
        assert profiling.counter("nn_launches") == 0 and profiling.counter_by("nn_launches") == {}
        snap = profiling.snapshot_counters()
        profiling.count("attention_launches", n=5)
        profiling.reset_counters(snap)
        assert profiling.counter("attention_launches") == 1
    finally:
        profiling.reset_counters(saved)


def _user_ranges(prof):
    """(name, start_ns, end_ns) of the profiler's user annotations, in start
    order, and each one's innermost enclosing annotation (None at the top)."""
    evs = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    evs.sort(key=lambda r: (r[1], -r[2]))
    parents, stack = [], []
    for name, s0, e0 in evs:
        while stack and stack[-1][2] <= s0:
            stack.pop()
        parents.append(stack[-1][0] if stack else None)
        stack.append((name, s0, e0))
    return evs, parents


# span -> the spans it may nest directly under, in the tiny run below
NESTING = {"track.match": {"lm_track"}, "track.motion": {"lm_track"},
           "track.ref_kf": {"lm_track"}, "track.local_map": {"lm_track"},
           "pose_opt": {"track.motion", "track.ref_kf", "track.local_map"},
           "insert.triangulate": {"new_kf"}, "insert.fuse": {"new_kf"},
           "insert.local_ba": {"new_kf"}, "insert.lm_stats": {"new_kf"},
           "loop.detect": {"place_recog"},
           "b2.nn_reduce": {"track.match", "track.ref_kf", "insert.triangulate", "loop.verify",
                            None},     # None: the two-view init's match
           "sp.backbone": {None}, "sp.select": {None}, "lg.layers": {None},
           "lg.assign": {None}, "b1.attention": {"lg.layers"}}


def test_spans_under_the_profiler_nest_and_keep_the_host_clock():
    world, frames, _ = torch_parity.synthetic_frames(10)
    slam = MonocularSLAM(world.cam_params, map_capacity=(32, 512, 8192), desc_dim=64,
                         enable_loop_closing=True, device="cpu")
    ext = SuperPointExtractor(max_keypoints=32, device="cpu")
    lg = LightGlueMatcher(num_layers=1, device="cpu")
    t0 = time.time_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch_parity.feed(slam, frames)
        out = ext(torch.rand(1, 48, 64))
        k = out["keypoints"] / 32.0 - 1.0
        lg(k, out["descriptors"], out["valid"], k, out["descriptors"], out["valid"])
    t1 = time.time_ns()
    assert slam.n_kf >= 3
    evs, parents = _user_ranges(prof)
    seen = {}
    for (name, _, _), parent in zip(evs, parents):
        if name in NESTING:
            assert parent in NESTING[name], (name, parent)
            seen[name] = seen.get(name, 0) + 1
    assert set(NESTING) - set(seen) <= {"track.ref_kf"}, set(NESTING) - set(seen)
    assert seen["b1.attention"] == 4      # self and cross attention, both ways
    # The host samples are the ranges' durations on the profiler's (epoch) clock.
    for name in ("lm_track", "track.local_map", "pose_opt", "insert.local_ba", "loop.detect"):
        ranges = [(s0, e0) for n, s0, e0 in evs if n == name]
        samples = slam.timers.samples[name]
        assert len(ranges) == len(samples) > 0, name
        for (s0, e0), ms in zip(ranges, samples):
            assert t0 <= s0 <= e0 <= t1
            assert abs((e0 - s0) / 1e6 - ms) < 5.0, (name, (e0 - s0) / 1e6, ms)


@pytest.mark.parametrize("mode_on", [True, False])
def test_sync_warnings_counted_by_innermost_span(monkeypatch, mode_on):
    """Synthetic sync warnings inside nested spans, under a recording
    catch_warnings as the benchmark's Tracer sets it: each counts once,
    against the innermost span, and the outer record holds every warning.
    With the sync debug mode off nothing is counted or touched."""
    monkeypatch.setattr(profiling, "_sync_warn_on", lambda: mode_on)
    timers = StageTimers()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        handler = warnings.showwarning
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.frame_sink(timers.samples):
                with timers.stage("lm_track"):
                    warnings.warn(SYNC)
                    with profiling.span("track.motion"):
                        with profiling.span("pose_opt"):
                            warnings.warn(SYNC)
                            warnings.warn(SYNC)
                            warnings.warn("not a sync")
                        warnings.warn(SYNC)
                    with profiling.span("b1.attention", sample=False):
                        warnings.warn(SYNC)
                with profiling.span("track.local_map"):
                    pass
            warnings.warn(SYNC)                       # outside every span
        assert warnings.showwarning is handler
    assert len(caught) == 7 and sum(SYNC in str(w.message) for w in caught) == 6
    counts = {k[:-len("/syncs")]: v for k, v in timers.samples.items() if k.endswith("/syncs")}
    if mode_on:
        assert counts == {"lm_track": [1], "track.motion": [1], "pose_opt": [2],
                          "b1.attention": [1], "track.local_map": [0]}
        assert "b1.attention" not in timers.samples
    else:
        assert counts == {}


class WrappedTimers:
    """What the benchmark's SpanTimers is: another object around a system's
    StageTimers that shares its samples."""

    def __init__(self, inner):
        self.inner = inner
        self.samples = inner.samples

    def stage(self, name):
        return self.inner.stage(name)

    def __getattr__(self, k):
        return getattr(self.inner, k)


class RangeLog:
    """Stands in for torch.profiler's ranges: notes each span's parent."""

    def __init__(self):
        self.stack, self.parents = [], {}

    def record_function(self, name):
        log = self

        class Range:
            def __enter__(self):
                log.parents.setdefault(name, set()).add(log.stack[-1] if log.stack else None)
                log.stack.append(name)

            def __exit__(self, *exc):
                log.stack.pop()
        return Range()


def test_loop_closer_samples_reach_a_wrapped_timers(monkeypatch):
    """The loop scene (tests/test_torch_loop_system.py) with the system's
    timers swapped for a wrapper after the first frames: the loop closer's
    spans and queue samples, fire and GBA chunks included, land in the
    wrapper's samples, each span under its parent."""
    world, frames, _ = torch_parity.ring_orbit_frames()
    slam = MonocularSLAM(world.cam_params, map_capacity=(128, 512, 8192), desc_dim=64,
                         enable_loop_closing=True, config=T.TrackerConfig(local_map_only=True),
                         loop_config=LoopConfig(min_covis_weight=20), device="cpu")
    torch_parity.feed(slam, frames[:5])
    slam.timers = WrappedTimers(slam.timers)
    ranges = RangeLog()
    monkeypatch.setattr(profiling, "_profiler_on", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", ranges.record_function)
    torch_parity.feed(slam, frames[5:])
    assert len(slam.loop_events) >= 1
    got = slam.timers.samples
    for name in ("loop.detect", "loop.verify", "loop.resolve", "loop.fire", "loop.sim3",
                 "loop.pose_graph", "loop.fuse", "loop.gba", "loop.detect_wait",
                 "loop.detect_shed", "insert.local_ba", "pose_opt"):
        assert got.get(name), name
    assert len(got["loop.gba"]) == LoopConfig().gba_iters - slam.loop_closer._gba_pending
    assert all(w >= 0 for w in got["loop.detect_wait"])
    p = ranges.parents
    assert p["loop.fire"] <= {"loop.resolve", "loop.hypothesis"}
    for child in ("loop.sim3", "loop.pose_graph", "loop.fuse"):
        assert p[child] == {"loop.fire"}, (child, p[child])
    assert p["loop.gba"] <= {"loop.fire", "place_recog"}
    assert p["place_recog"] <= {"new_kf", None}
    assert p["loop.detect"] == {"place_recog"}


# --- the benchmark's readers of these samples -----------------------------------

def _frame(i, stages, profiled=False):
    return {"i": i, "ms": 100.0, "profiled": profiled, "kf_rose": False, "loop_rose": False,
            "stages": stages}


def _record():
    """A traced run's record (harness.build_record) as the readers see it:
    the window's frames with their samples, the traced stretch last."""
    frames = [_frame(0, {"pose_opt": [2.0, 3.0], "insert.local_ba": [40.0]}),
              _frame(1, {"pose_opt": [7.0], "loop.pose_graph": [900.0],
                         "loop.gba": [100.0, 80.0]}),
              _frame(2, {"pose_opt": [4.0], "loop.gba": [70.0]}),
              _frame(3, {"loop.gba": [60.0], "insert.local_ba": [50.0, 10.0]}),
              _frame(4, {"pose_opt": [1.0], "loop.pose_graph": [500.0], "loop.gba": [1.0]}),
              _frame(5, {"pose_opt": [99.0], "lm_track/syncs": [1], "pose_opt/syncs": [3, 2],
                         "track.match/syncs": [2], "insert.fuse/syncs": [7]}, profiled=True),
              _frame(6, {"lm_track/syncs": [1], "track.motion/syncs": [1],
                         "insert.local_ba": [999.0]}, profiled=True)]
    return {"frames": frames, "stages": {"loop.detect_wait": [0, 2, 1, 5]},
            "trace": {"frames": 2}}


READ_BY_HAND = {"track_syncs_per_frame": 5.0,    # (1 + 3 + 2 + 2 + 1 + 1) / 2 traced frames
                "pose_opt_ms": 4.5,              # median of the sums 5, 7, 4, 1 (5 traced)
                "local_ba_ms": 40.0,             # 40, 50, 10 (999 traced)
                "loop_pose_graph_ms": 900.0,     # the first fire
                "loop_gba_ms": 310.0,            # 100 + 80 + 70 + 60, up to the next fire
                "loop_detect_wait_polls": 2.0}


def _reader(name):
    return importlib.import_module(f"slambench.metrics.{name}").read


@pytest.mark.parametrize("name", sorted(READ_BY_HAND))
def test_reader_by_hand(name):
    assert _reader(name)(_record()) == pytest.approx(READ_BY_HAND[name])


@pytest.mark.parametrize("name", sorted(READ_BY_HAND))
def test_reader_with_nothing_to_read(name):
    rec = _record()
    for f in rec["frames"]:
        f["stages"] = {"lm_track": [50.0]}
    rec["stages"] = {"lm_track": [50.0]}
    assert _reader(name)(rec) is None


def test_gba_chunks_past_the_unprofiled_frames_read_none():
    rec = _record()
    rec["frames"] = rec["frames"][:4] + [_frame(4, {"loop.gba": [5.0]}, profiled=True)]
    assert _reader("loop_gba_ms")(rec) is None
