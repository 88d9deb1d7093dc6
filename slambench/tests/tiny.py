"""A checkout of the benchmark cut to run on the CPU: slambench/ and
BENCHMARK.json copied into a temporary directory, the port and the shipped
weights linked in, and a tiny cell (240x320, 256 keypoints, two LightGlue
layers, 240 frames from one of 24 starts) added as data: its own configuration and traffic files
and BENCHMARK.json entries."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny_mono.tiny"
TINY_LIMITS = {"sp_logp_gap": 0.5, "sp_desc_gap": 0.05, "lg_gap": 0.6, "nn_gap": 1e-3}


def checkout(tmp: str, link_program: bool = True) -> str:
    """A copy of the benchmark under tmp with the tiny cell added; with
    link_program the port and the weights are linked in (without, the copy
    holds only BENCHMARK.json and slambench/)."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "slambench"), os.path.join(root, "slambench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    if link_program:
        os.symlink(os.path.join(REPO, "rover_slam_tpu_torch"),
                   os.path.join(root, "rover_slam_tpu_torch"))
        os.makedirs(os.path.join(root, "rover_slam_tpu"))
        os.symlink(os.path.join(REPO, "rover_slam_tpu", "assets"),
                   os.path.join(root, "rover_slam_tpu", "assets"))
    add_tiny_cell(root)
    return root


def add_tiny_cell(root: str):
    cfg = json.load(open(os.path.join(root, "slambench", "configs", "euroc_mono.json")))
    cfg.update(name="tiny_mono", pipeline=4,   # the fused inserts call B2 within seconds
               width=320, height=240, fx=229.0, fy=229.0, cx=160.0, cy=120.0,
               capacities={"keyframes": 32, "keypoints": 256, "landmarks": 4096})
    cfg["superpoint"]["max_keypoints"] = 256
    cfg["lightglue"]["layers"] = 2
    cfg["guarantees"] = dict(cfg["guarantees"], loops_min=0)
    cfg["limits"] = dict(TINY_LIMITS)
    write_json(os.path.join(root, "slambench", "configs", "tiny_mono.json"), cfg)
    traffic = json.load(open(os.path.join(root, "slambench", "traffic", "patrol.json")))
    traffic["route"] = dict(traffic["route"], frames=240, kind="circle")
    traffic.update(start_offsets=24, warm_frames=20, trace_tail_s=1.5)
    write_json(os.path.join(root, "slambench", "traffic", "tiny.json"), traffic)
    m = json.load(open(os.path.join(root, "BENCHMARK.json")))
    m["configs"].append({"name": "tiny_mono", "source": "test", "reduced": [], "why": "test",
                         "file": "slambench/configs/tiny_mono.json"})
    m["workloads"].append({"name": TINY, "config": "tiny_mono", "traffic": "tiny", "chips": 1,
                           "why": "test"})
    for metric in m["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(TINY)
    write_json(os.path.join(root, "BENCHMARK.json"), m)


def write_json(path: str, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


DRIVER = """
import json, sys, time
T = time.perf_counter()
sys.path.insert(0, {root!r})
{prelude}
from slambench import harness
harness.set_cache_env({root!r})
code = harness.main({argv!r}, t_process=T, device="cpu")
print("FORBIDDEN " + json.dumps(harness.forbidden_modules()), file=sys.stderr)
sys.exit(code)
"""


def run_cpu(root: str, argv: list, prelude: str = "", timeout: int = 600):
    """One run of the harness on the CPU in a fresh interpreter: (exit code,
    last stdout line as JSON or None, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", DRIVER.format(root=root, argv=argv,
                                                              prelude=prelude)],
                       cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines else None
    return p.returncode, last, p.stderr


def tiny_argv(seed: int = 3, seconds: float = 4.0, trace: int = 0, workload: str = TINY):
    return ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
