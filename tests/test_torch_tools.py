"""The port's tools: utils/profiling.py writes a Chrome trace on the CPU
that holds the spans; utils/viz.py draws the same RGB arrays as
the JAX package's viz from the same map (matplotlib, where installed); the
demo (slam/demo.py) runs on the CPU and prints an ATE."""
import json
import os

import numpy as np
import pytest
import torch

import torch_parity
from rover_slam_tpu_torch.map import map_state as tms
from rover_slam_tpu_torch.slam import demo
from rover_slam_tpu_torch.utils import profiling


def test_device_trace_holds_the_annotations(tmp_path):
    with profiling.device_trace(str(tmp_path)) as logdir:
        for i in range(3):
            with profiling.span(f"frame#{i}"), profiling.span("track_frame"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert logdir == str(tmp_path)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"frame#0", "frame#2", "track_frame", "aten::mm"} <= names


def _map_state():
    rng = np.random.default_rng(0)
    st = tms.empty_map(K=8, N=16, L=300, D=32, device="cpu")
    R = np.stack([np.eye(3, dtype=np.float32)] * 8)
    t = rng.normal(0, 1, (8, 3)).astype(np.float32)
    return st.replace(lm_pos=torch.from_numpy(rng.normal(0, 5, (300, 3)).astype(np.float32)),
                      lm_active=torch.from_numpy(rng.random(300) > 0.3),
                      kf_active=torch.from_numpy(np.arange(8) < 5),
                      kf_R_cw=torch.from_numpy(R), kf_t_cw=torch.from_numpy(t))


def test_viz_draws_what_the_jax_viz_draws(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.image
    from rover_slam_tpu.utils import viz as jviz
    from rover_slam_tpu_torch.utils import viz as tviz
    st = _map_state()
    rng = np.random.default_rng(1)
    traj = np.cumsum(rng.normal(0, 0.1, (20, 3)), 0)
    imgs = []
    for mod, state, name in ((tviz, st, "port.png"), (jviz, torch_parity.to_jax_state(st),
                                                      "jax.png")):
        out = mod.plot_map(state, str(tmp_path / name), trajectory=traj, gt=traj + 0.05,
                           title="map")
        imgs.append(matplotlib.image.imread(out))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    image = rng.random((60, 80)).astype(np.float32)
    kpts = rng.uniform(0, 80, (40, 2)).astype(np.float32)
    lm_idx = np.where(rng.random(40) > 0.5, 3, -1)
    got = tviz.draw_frame_overlay(torch.from_numpy(image), torch.from_numpy(kpts),
                                  torch.from_numpy(lm_idx), str(tmp_path / "o.png"))
    want = jviz.draw_frame_overlay(image, kpts, lm_idx)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    assert os.path.exists(tmp_path / "o.png")


def test_demo_runs_on_the_cpu(capsys):
    assert demo.main(["--frames", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "8 frames in" in out.out and "ATE" in out.out and " cm over " in out.out
    assert "device: cpu" in out.err
