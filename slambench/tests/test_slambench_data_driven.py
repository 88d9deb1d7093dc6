"""The harness is driven by data: in a copy of slambench/, a new
configuration file, traffic file and metric reader, with their
BENCHMARK.json entries, make a new cell and a new per-layer metric that run,
with no file that was there edited; and a profiler range that the program
opens (here a stand-in that wraps the port's track_frame) reaches the
record a new metric file reads."""
import hashlib
import json
import os

from slambench.tests import tiny


def digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "slambench")):
        for name in files:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


# a span the program opens itself, unknown to the harness
PROGRAM_SPAN = """
import torch
from rover_slam_tpu_torch.slam import system as S
_tf = S.MonocularSLAM.track_frame
def track_frame(self, *a, **k):
    with torch.profiler.record_function("port:track_frame"):
        return _tf(self, *a, **k)
S.MonocularSLAM.track_frame = track_frame
"""


def test_new_cell_and_metric_by_adding_files(tmp_path):
    root = tiny.checkout(str(tmp_path))
    before = digests(root)
    cfg = json.load(open(os.path.join(root, "slambench", "configs", "tiny_mono.json")))
    cfg.update(name="tiny_wide", width=384, cx=192.0)
    tiny.write_json(os.path.join(root, "slambench", "configs", "tiny_wide.json"), cfg)
    traffic = json.load(open(os.path.join(root, "slambench", "traffic", "tiny.json")))
    traffic["route"] = dict(traffic["route"], orbit_radius=4.5)
    tiny.write_json(os.path.join(root, "slambench", "traffic", "noisy.json"), traffic)
    with open(os.path.join(root, "slambench", "metrics", "stretch_frames.py"), "w") as f:
        f.write('"""stretch_frames: frames in the traced stretch."""\n\n\n'
                'def read(rec):\n    return rec["trace"]["frames"]\n')
    with open(os.path.join(root, "slambench", "metrics", "port_track_host_ms.py"), "w") as f:
        f.write('"""port_track_host_ms: host ms a traced frame in the program\'s own\n'
                '"port:track_frame" range."""\n\n\n'
                'def read(rec):\n    r = rec["trace"]["ranges"].get("port:track_frame")\n'
                '    return r[1] / 1e3 / rec["trace"]["frames"] if r else None\n')
    m = json.load(open(os.path.join(root, "BENCHMARK.json")))
    m["configs"].append({"name": "tiny_wide", "source": "test", "reduced": [], "why": "test",
                         "file": "slambench/configs/tiny_wide.json"})
    m["workloads"].append({"name": "tiny_wide.noisy", "config": "tiny_wide", "traffic": "noisy",
                           "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "stretch_frames", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "whole frame",
                           "moves": "frame_ms_median", "workloads": ["tiny_wide.noisy"]})
    m["per_layer"].append({"name": "port_track_host_ms", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "tracking",
                           "moves": "frame_ms_median", "workloads": ["tiny_wide.noisy"]})
    tiny.write_json(os.path.join(root, "BENCHMARK.json"), m)
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())   # nothing that was there changed

    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(workload="tiny_wide.noisy", trace=1),
                                   prelude=PROGRAM_SPAN)
    assert code == 0, err[-3000:]
    assert last["metrics"]["stretch_frames"]["value"] >= 3
    assert last["metrics"]["port_track_host_ms"]["value"] > 0
    assert "tiny_wide.noisy seed 3" in err
