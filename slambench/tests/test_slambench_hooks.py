"""The hooks a new configuration fills with new files alone, on the tiny CPU
cell (tiny.py): a judge the configuration names (slambench/judges/), a
sample kind its system declares (SAMPLE_P), frames of two images from its
generator, and loop guarantees its traffic states. Also: a judge over its
limit makes `correct` false, a number without a limit fails the run, a
traffic may state no guarantee but the loop counts, and euroc_mono's
system draws its samples exactly as the harness did before system kinds
existed."""
import json
import os
import random

import numpy as np
import pytest

from slambench import harness
from slambench.tests import tiny
from slambench.tests.test_slambench_controls import control_lines
from slambench.tests.test_slambench_data_driven import digests

PAIR = "tiny_pair.pair"

# a generator whose frames are two images: the ring orbit's view and the
# view from 8 cm to its right, [2, H, W]
PAIR_SCENE = '''"""ring_orbit with two images a frame."""
import numpy as np

from slambench.scenes import ring_orbit
from slambench.scenes.ring_orbit import for_seed  # noqa: F401


class PairScene(ring_orbit.Scene):
    def render(self, i):
        left = ring_orbit.render_photo_frame(self.world, self.R_cw[i], self.t_cw[i])
        right = ring_orbit.render_photo_frame(self.world, self.R_cw[i],
                                              self.t_cw[i] - np.float32([0.08, 0.0, 0.0]))
        return np.stack([left, right])


def make_route(traffic, config):
    return PairScene(*ring_orbit.make_route(traffic, config))


def frame_key(traffic, config):
    return dict(ring_orbit.frame_key(traffic, config), generator="ring_pair")
'''

# a system that tracks the first image of each frame with the monocular
# system and keeps, in a sample kind of its own, the image it uploaded
PAIR_SYSTEM = '''"""The monocular system on the first image of two-image frames."""
import torch

from slambench.systems import monocular

SAMPLE_P = {"upload": 0.5}


def upload(raw, dev):
    return torch.from_numpy(raw).to(dev).float().div_(255.0)


class System(monocular.System):
    def image(self, i):
        raw = self.frames[i][0]
        img = upload(raw, self.dev)[None]
        if self.cap.draw("upload"):
            self.cap.keep("upload", image=img[0].clone(), raw=torch.from_numpy(raw.copy()))
        return img
'''

# a judge of the uploads: the device image against the camera's bytes
# scaled in float32; its control scales them through fp8
PAIR_JUDGE = '''"""tiny_gap: the widest |uploaded image - camera bytes / 255| over the
kept uploads."""
from slambench.reference.precision import rnd


def _gap(samples, precision=None):
    gaps = []
    for s in samples:
        ref = s["raw"].float() / 255.0
        side = s["image"].float() if precision is None else rnd(ref, precision)
        gaps.append((side - ref).abs().max().item())
    return max(gaps) if gaps else None


def judge(cfg, scene, cap, trees, dev, outcome, control):
    up = cap.samples["upload"]
    return {"tiny_gap": _gap(up)}, ({"tiny_gap": _gap(up, "fp8")} if control else {})
'''

IMAGES_METRIC = '''"""images_per_frame: the record's images a frame."""


def read(rec):
    return rec["images_per_frame"]
'''


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


def add_pair_cell(root, limits=None):
    """The two-image cell as new files and new manifest entries: a scene
    generator, a system, a judge, a configuration, a traffic and a metric."""
    sb = os.path.join(root, "slambench")
    write(os.path.join(sb, "scenes", "ring_pair.py"), PAIR_SCENE)
    write(os.path.join(sb, "systems", "tiny_pair.py"), PAIR_SYSTEM)
    write(os.path.join(sb, "judges", "tiny_gap.py"), PAIR_JUDGE)
    write(os.path.join(sb, "metrics", "images_per_frame.py"), IMAGES_METRIC)
    cfg = json.load(open(os.path.join(sb, "configs", "tiny_mono.json")))
    cfg.update(name="tiny_pair", system="tiny_pair", checks=["tiny_gap"])
    cfg["limits"] = dict(cfg["limits"], tiny_gap=1e-6) if limits is None else limits
    tiny.write_json(os.path.join(sb, "configs", "tiny_pair.json"), cfg)
    traffic = json.load(open(os.path.join(sb, "traffic", "tiny.json")))
    traffic["generator"] = "ring_pair"
    tiny.write_json(os.path.join(sb, "traffic", "pair.json"), traffic)
    m = json.load(open(os.path.join(root, "BENCHMARK.json")))
    m["configs"].append({"name": "tiny_pair", "source": "test", "reduced": [], "why": "test",
                         "file": "slambench/configs/tiny_pair.json"})
    m["workloads"].append({"name": PAIR, "config": "tiny_pair", "traffic": "pair", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "images_per_frame", "unit": "images", "better": "higher",
                           "source": "program_counter", "layer": "whole frame",
                           "moves": "frame_ms_median", "workloads": [PAIR]})
    for metric in m["per_layer"]:
        if metric["name"] == "frame_mfu_pct":
            metric["workloads"].append(PAIR)
    tiny.write_json(os.path.join(root, "BENCHMARK.json"), m)


def test_judge_sample_kind_and_two_image_frames_by_adding_files(tmp_path):
    root = tiny.checkout(str(tmp_path))
    before = digests(root)
    add_pair_cell(root)
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())   # nothing that was there changed
    assert len(after) > len(before)

    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(workload=PAIR, trace=1))
    assert code == 0, err[-3000:]
    assert last["checks"]["tiny_gap"]["limit"] == 1e-6
    assert last["checks"]["tiny_gap"]["value"] is not None
    assert last["correct"] is True, last["checks"]
    assert list(last["checks"])[-1] == "tiny_gap" and list(last)[-1] == "checks"
    assert last["metrics"]["images_per_frame"]["value"] == 2
    assert last["metrics"]["frame_mfu_pct"]["value"] > 0
    assert any(ln.startswith("check tiny_gap ") and ln.endswith(" ok") for ln in err.splitlines())
    # the render cache holds [F, 2, H, W]
    (frames,) = os.listdir(os.path.join(root, ".slambench_cache", "frames"))
    shape = np.load(os.path.join(root, ".slambench_cache", "frames", frames), mmap_mode="r").shape
    assert shape == (264, 2, 240, 320)


# the program's upload altered where it is produced: the image handed to
# SuperPoint is 2 % dimmer than the camera's bytes
DIMMED = """
from slambench.systems import tiny_pair
_upload = tiny_pair.upload
tiny_pair.upload = lambda raw, dev: _upload(raw, dev) * 0.98
"""


def test_judge_over_its_limit_makes_correct_false(tmp_path):
    root = tiny.checkout(str(tmp_path))
    add_pair_cell(root)
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(workload=PAIR), prelude=DIMMED)
    assert code == 0, err[-3000:]
    assert last["checks"]["tiny_gap"]["value"] > last["checks"]["tiny_gap"]["limit"]
    assert last["correct"] is False


def test_a_number_without_a_limit_fails_the_run(tmp_path):
    root = tiny.checkout(str(tmp_path))
    add_pair_cell(root, limits=dict(tiny.TINY_LIMITS))   # no limit for tiny_gap
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(workload=PAIR))
    assert code != 0 and last is None
    assert "gives no limit" in err and "'tiny_gap'" in err


def test_the_control_reports_a_judges_own_readings(tmp_path):
    root = tiny.checkout(str(tmp_path))
    add_pair_cell(root)
    (line,) = control_lines(root, ["--workload", PAIR, "--seeds", "5", "--seconds", "3"], "cpu")
    assert line["program"]["tiny_gap"] <= 1e-6 < line["control"]["tiny_gap"]


def with_route_guarantees(root, guarantees):
    path = os.path.join(root, "slambench", "traffic", "tiny.json")
    traffic = json.load(open(path))
    traffic["guarantees"] = guarantees
    tiny.write_json(path, traffic)


@pytest.mark.parametrize("key", ["tracked_min", "ate_cm_max", "loops"])
def test_a_traffic_states_only_loop_guarantees(tmp_path, key):
    root = tiny.checkout(str(tmp_path))
    with_route_guarantees(root, {"loops_min": 0, key: 0.5})
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv())
    assert code != 0 and last is None
    assert f"states guarantees ['{key}']" in err


def test_route_guarantees_take_the_place_of_the_configurations():
    cfg = {"guarantees": {"tracked_min": 0.9, "loops_min": 1, "ate_alignment": "sim3",
                          "ate_cm_max": 20.0}}
    assert harness.route_guarantees(cfg, {}, "patrol") == cfg["guarantees"]
    g = harness.route_guarantees(cfg, {"guarantees": {"loops_min": 0, "loops_max": 0}}, "x")
    assert g == {"tracked_min": 0.9, "loops_min": 0, "loops_max": 0, "ate_alignment": "sim3",
                 "ate_cm_max": 20.0}
    with pytest.raises(SystemExit):
        harness.route_guarantees(cfg, {"guarantees": {"tracked_min": 0.5}}, "x")


# a loop closed on the main system's call number AT: 21 is the window's
# first frame (after 20 warm-up frames), 5 a warm-up frame
LOOP_CLOSED = """
from rover_slam_tpu_torch.slam import system as S
_tf = S.MonocularSLAM.track_frame
def track_frame(self, *a, **k):
    self._calls = getattr(self, "_calls", 0) + 1
    out = _tf(self, *a, **k)
    if self._calls == {at}:
        self.loop_events.append((-1, None))
    return out
S.MonocularSLAM.track_frame = track_frame
"""


@pytest.mark.parametrize("at", [None, 21, 5], ids=["no_loop", "in_window", "in_warm_up"])
def test_loops_max_fails_a_run_that_closes_a_loop(tmp_path, at):
    """loops_max holds every loop since the run's system started: one closed
    in the warm-up frames fails as one closed in the window does."""
    root = tiny.checkout(str(tmp_path))
    with_route_guarantees(root, {"loops_min": 0, "loops_max": 0})
    prelude = LOOP_CLOSED.format(at=at) if at else ""
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(), prelude=prelude)
    assert code == 0, err[-3000:]
    assert last["checks"]["loops_total_max"] == {"value": int(at is not None), "limit": 0}
    assert "loops_in_window" not in last["checks"]
    assert last["correct"] is (at is None), last["checks"]


class CaptureBefore:
    """harness.Capture's draws as they were before a system could declare
    sample kinds (three kinds, one stream of draws)."""

    SAMPLE_P = {"superpoint": 0.12, "lightglue": 0.12, "nn": 0.1}
    SAMPLE_MAX = 16

    def __init__(self, seed):
        self.rng = random.Random(int(seed) * 7919 + 17)
        self.in_window = False
        self.samples = {k: [] for k in self.SAMPLE_P}

    def draw(self, kind, force=False):
        if not self.in_window:
            return False
        hit = self.rng.random() < self.SAMPLE_P[kind]
        n = len(self.samples[kind])
        return ((force or n == 0) and n <= self.SAMPLE_MAX) or (hit and n < self.SAMPLE_MAX)


LOG_DRAWS = """
import json
from slambench import harness
_draw = harness.Capture.draw
def draw(self, kind, force=False):
    r = _draw(self, kind, force)
    print("DRAW " + json.dumps([kind, force, self.in_window, r, self.frame]), file=sys.stderr)
    return r
harness.Capture.draw = draw
"""


def test_euroc_mono_draws_the_samples_it_drew_before(tmp_path):
    """The monocular system declares no kind: every draw of a run on the
    tiny cell (euroc_mono's system) decides as the harness before system
    kinds decided, on the same seed."""
    root = tiny.checkout(str(tmp_path))
    seed = 2 ** 31 + 77
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(seed=seed), prelude=LOG_DRAWS)
    assert code == 0, err[-3000:]
    draws = [json.loads(ln[5:]) for ln in err.splitlines() if ln.startswith("DRAW ")]
    before = CaptureBefore(seed)
    kept = {k: [] for k in before.SAMPLE_P}
    for kind, force, in_window, got, frame in draws:
        before.in_window = in_window
        assert before.draw(kind, force) is got, (kind, frame)
        if got:
            before.samples[kind].append(frame)
            kept[kind].append(frame)
    assert all(kept.values()), kept        # every kind drew in the window


def test_a_system_adds_sample_kinds_and_may_not_change_the_harnesss():
    cap = harness.Capture(5, False, {"preint": 0.3})
    assert cap.sample_p == {**harness.Capture.SAMPLE_P, "preint": 0.3}
    assert set(cap.samples) == {"superpoint", "lightglue", "nn", "preint"}
    assert harness.Capture(5, False).sample_p == harness.Capture.SAMPLE_P
    with pytest.raises(SystemExit):
        harness.Capture(5, False, {"nn": 0.5})
