"""Each per-layer reader on a synthetic traced-run record, against the
number worked out by hand; a reader with nothing to read returns None."""
import importlib
import json
import os

import pytest

from slambench import flops

HERE = os.path.dirname(os.path.abspath(__file__))
MANIFEST = json.load(open(os.path.join(HERE, "..", "..", "BENCHMARK.json")))
CFG = {"lightglue": {"dim": 256, "layers": 9}}


def frame(i, ms, profiled=False, kf=False, loop=False, stages=None):
    return {"i": i, "ms": ms, "profiled": profiled, "kf_rose": kf, "loop_rose": loop,
            "stages": stages or {}}


def record():
    frames = [frame(0, 100.0, stages={"lm_track": [40.0]}),
              frame(1, 300.0, kf=True, stages={"lm_track": [60.0]}),
              frame(2, 999.0, profiled=True, kf=True, loop=True, stages={"lm_track": [500.0]}),
              frame(3, 200.0, profiled=True),
              frame(4, 4000.0, loop=True, stages={"lm_track": [50.0]})]
    return {"config": CFG, "image_hw": [480, 752], "images_per_frame": 1, "frames": frames,
            "lightglue_calls": [(0, 1, 1024, 1024, False), (2, 1, 1024, 1024, True),
                                (3, 2, 1024, 1024, True)],
            "nn_calls": [(2, 1024, 1024, 256, True), (4, 1024, 16384, 256, False)],
            "trace": {"wall_s": 2.0, "busy_us": 150000.0, "kernels": 20000, "frames": 2,
                      "syncs": 170, "device_ops": {"void flash_tc_kernel<64>(x)": [720.0, 108],
                                                   "void nn_tc_kernel(y)": [10.0, 1],
                                                   "nn_merge_kernel": [2.0, 1],
                                                   "Memcpy HtoD": [5.0, 3]},
                      "range_device_us": {"superpoint": 6000.0, "lightglue": 40000.0},
                      "range_kernels": {}, "idle_us_by_range": {}}}


def read(name, rec):
    return importlib.import_module(f"slambench.metrics.{name}").read(rec)


def test_every_manifest_metric_has_a_reader():
    for m in MANIFEST["per_layer"]:
        assert callable(importlib.import_module(f"slambench.metrics.{m['name']}").read)


def test_readers_by_hand():
    rec = record()
    assert read("device_idle_pct", rec) == pytest.approx(100 * (1 - 0.15 / 2.0))
    assert read("launches_per_frame", rec) == 10000
    assert read("host_syncs_per_frame", rec) == 85
    assert read("superpoint_ms", rec) == pytest.approx(3.0)
    assert read("lightglue_ms", rec) == pytest.approx(20.0)
    assert read("track_ms", rec) == pytest.approx(50.0)      # frames 0, 1, 4
    assert read("insert_frame_ms", rec) == pytest.approx(300.0)   # frame 2 is profiled
    assert read("loop_fire_ms", rec) == pytest.approx(4000.0)
    assert read("frame_ms_p90", rec) is None   # three unprofiled frames: too few
    rec["frames"] = [frame(i, float(i)) for i in range(1, 21)] + [frame(99, 1e6, profiled=True)]
    assert read("frame_ms_p90", rec) == pytest.approx(18.1)
    rec = record()
    sp = flops.superpoint_flops(480, 752)
    lg = flops.lightglue_flops(1, 1024, 1024, 256, 9)
    want = 100 * (3 * sp + lg) / (4.4 * flops.PEAK_BF16_FLOPS)
    assert read("frame_mfu_pct", rec) == pytest.approx(want)
    least = sum(flops.least_seconds(flops.attention_call_flops(*c),
                                    flops.attention_call_bytes(*c))
                for b in (1, 2) for c in flops.lightglue_attention_calls(b, 1024, 1024, 256, 9))
    assert read("attention_roofline_pct", rec) == pytest.approx(100 * least / 720e-6)
    least_nn = flops.least_seconds(flops.nn_reduce_flops(1024, 1024, 256),
                                   flops.nn_reduce_bytes(1024, 1024, 256))
    assert read("nn_match_roofline_pct", rec) == pytest.approx(100 * least_nn / 12e-6)


def test_readers_with_nothing_to_read():
    rec = record()
    rec["trace"].update(busy_us=0.0, kernels=0, device_ops={}, range_device_us={})
    rec["frames"] = [frame(0, 100.0)]
    rec["lightglue_calls"], rec["nn_calls"] = [], []
    for name in ("device_idle_pct", "launches_per_frame", "superpoint_ms", "lightglue_ms",
                 "track_ms", "insert_frame_ms", "loop_fire_ms", "frame_ms_p90",
                 "attention_roofline_pct", "nn_match_roofline_pct"):
        assert read(name, rec) is None, name


def test_every_range_gets_its_device_and_idle_time():
    """harness.attribute on hand-made ranges and kernels: a range no reader
    knows of (a span the program opens itself, nested in the benchmark's)
    gets the device time of the kernels launched inside it, inclusive and by
    chain; a kernel on another thread, or outside every range, goes to its
    own thread's ranges or to "(none)"; idle gaps go to the main thread's
    innermost range."""
    from slambench.harness import attribute
    ranges = [(1, 0, 100, "frame"), (1, 10, 60, "stage:lm_track"),
              (1, 20, 40, "port:pose_opt"), (1, 70, 90, "lightglue"),
              (2, 0, 100, "loop_thread")]
    kernels = [(1, 25, 5.0), (1, 30, 7.0), (1, 50, 2.0), (1, 80, 11.0), (1, 95, 1.0),
               (2, 30, 3.0), (1, 150, 4.0), (None, 0, 6.0)]
    gaps = [(35, 100.0), (65, 20.0), (200, 8.0)]
    out = attribute(ranges, kernels, gaps, main_thread=1)
    dev = out["range_device_us"]
    assert dev["port:pose_opt"] == pytest.approx(12.0)
    assert dev["stage:lm_track"] == pytest.approx(14.0)
    assert dev["frame"] == pytest.approx(26.0)
    assert dev["lightglue"] == pytest.approx(11.0)
    assert dev["loop_thread"] == pytest.approx(3.0)
    assert dev["(none)"] == pytest.approx(10.0)
    assert out["range_kernels"]["port:pose_opt"] == 2
    assert out["range_self_device_us"]["stage:lm_track"] == pytest.approx(2.0)
    assert out["range_self_device_us"]["frame"] == pytest.approx(1.0)
    assert out["chain_device_us"]["frame > stage:lm_track > port:pose_opt"] == pytest.approx(12.0)
    assert out["idle_us_by_range"] == {"port:pose_opt": 100.0, "frame": 20.0, "(none)": 8.0}
    assert out["idle_us_by_chain"]["frame > stage:lm_track > port:pose_opt"] == 100.0
