"""The explore traffic's route (slambench/traffic/explore.json, the data of
the queued euroc_mono.explore cell) revisits nothing, and frame_mfu_pct
counts SuperPoint once per image of a frame."""
import json
import os

import numpy as np
import pytest

from slambench import flops, harness
from slambench.scenes import ring_orbit
from slambench.tests.test_slambench_metrics import read, record

SB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(*parts):
    with open(os.path.join(SB, *parts)) as f:
        return json.load(f)


def in_image(route, i) -> set:
    """The sprites in route frame i's image: z > 0.5 and the projection
    inside the image (0 <= u < W, 0 <= v < H), by render_photo_frame's
    projection."""
    h, w = route.image_hw
    fx, fy, cx, cy = np.asarray(route.cam[:4], np.float64)
    xc = (np.asarray(route.R_cw[i], np.float64) @ route.world.points.T).T + route.t_cw[i]
    z = xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
    return set(np.flatnonzero((z > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)).tolist())


def test_explore_route_revisits_nothing():
    """No sprite in the image of the route's first frame is in its last
    frame's, nor in the last frame of any seed's run (a run spans
    route["frames"] frames from one of the first start_offsets)."""
    traffic = load("traffic", "explore.json")
    route = ring_orbit.make_route(traffic, load("configs", "euroc_mono.json"))
    n, frames = len(route.times), int(traffic["route"]["frames"])
    assert n == ring_orbit.route_length(traffic) == 2046
    first, last = in_image(route, 0), in_image(route, n - 1)
    assert len(first) > 100 and len(last) > 100
    assert not first & last
    for k in range(int(traffic["start_offsets"])):
        assert not in_image(route, k) & in_image(route, k + frames - 1), k


def test_explore_states_no_loop():
    cfg, traffic = load("configs", "euroc_mono.json"), load("traffic", "explore.json")
    g = harness.route_guarantees(cfg, traffic, "explore")
    assert g["loops_min"] == 0 and g["loops_max"] == 0
    assert g["tracked_min"] == cfg["guarantees"]["tracked_min"]
    assert g["ate_cm_max"] == cfg["guarantees"]["ate_cm_max"]
    patrol = harness.route_guarantees(cfg, load("traffic", "patrol.json"), "patrol")
    assert patrol == cfg["guarantees"]
    # the configuration the patrol's cell runs is euroc_mono's own
    assert harness.Cell(os.path.dirname(SB), "euroc_mono.patrol").config == cfg


def frame_mfu_before(rec):
    """frame_mfu_pct as it read before frames could hold more than one
    image."""
    from slambench.record import unprofiled
    frames = unprofiled(rec)
    ids = {f["i"] for f in frames}
    h, w = rec["image_hw"]
    lg = rec["config"]["lightglue"]
    ops = len(frames) * flops.superpoint_flops(h, w)
    ops += sum(flops.lightglue_flops(b, n, m, lg["dim"], lg["layers"])
               for fr, b, n, m, prof in rec["lightglue_calls"] if fr in ids and not prof)
    seconds = sum(f["ms"] for f in frames) / 1e3
    return 100.0 * ops / (seconds * flops.PEAK_BF16_FLOPS)


def test_frame_mfu_on_a_mono_record_reads_as_before():
    rec = record()
    assert rec["images_per_frame"] == 1
    assert read("frame_mfu_pct", rec) == frame_mfu_before(rec)


def test_frame_mfu_counts_superpoint_once_per_image():
    rec = record()
    rec["images_per_frame"] = 2
    sp = flops.superpoint_flops(480, 752)
    lg = flops.lightglue_flops(1, 1024, 1024, 256, 9)
    # three unprofiled frames of two images each, 4.4 s of frames
    want = 100 * (3 * 2 * sp + lg) / (4.4 * flops.PEAK_BF16_FLOPS)
    assert read("frame_mfu_pct", rec) == pytest.approx(want, rel=1e-12)
    rec["images_per_frame"] = 1
    mono = read("frame_mfu_pct", rec)
    rec["images_per_frame"] = 2
    assert read("frame_mfu_pct", rec) - mono == pytest.approx(
        100 * 3 * sp / (4.4 * flops.PEAK_BF16_FLOPS), rel=1e-12)
