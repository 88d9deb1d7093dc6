"""The port's trajectory files and metrics against the JAX package's
(rover_slam_tpu/utils/trajectory.py) on the same poses: quaternion
conversions (atol 1e-12, both in float64 numpy), the TUM and KITTI files byte
for byte, their readers exactly, RPE to 1e-12; and the port's ATE CLI against
evaluation/evaluate_ate_scale.py on tests/test_dataset_native.py's case: the
same printed line."""
import os
import subprocess
import sys

import numpy as np
import pytest

from rover_slam_tpu.utils import trajectory as jtr
from rover_slam_tpu_torch.utils import trajectory as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poses(n=12, seed=0):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    R = Rotation.random(n, random_state=seed).as_matrix()
    R[0] = np.eye(3)
    R[1] = np.diag([1.0, -1.0, -1.0])            # trace -1: the argmax branch
    R[2] = np.diag([-1.0, 1.0, -1.0])
    t = rng.normal(0, 3, (n, 3))
    return R.astype(np.float32), t.astype(np.float32)


def test_quaternions():
    R, _ = _poses()
    for Ri in R.astype(np.float64):
        q_t, q_j = ttr.rot_to_quat(Ri), jtr.rot_to_quat(Ri)
        np.testing.assert_allclose(q_t, q_j, atol=1e-12, rtol=0)
        np.testing.assert_allclose(ttr.quat_to_rot(q_t), jtr.quat_to_rot(q_j), atol=1e-12)
        np.testing.assert_allclose(ttr.quat_to_rot(q_t), Ri, atol=1e-6)


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_files_byte_for_byte(tmp_path, fmt):
    R, t = _poses()
    times = 1403636579.763 + 0.05 * np.arange(len(R))
    pt, pj = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"jax.{fmt}")
    if fmt == "tum":
        ttr.save_tum(pt, times, R, t)
        jtr.save_tum(pj, times, R, t)
    else:
        ttr.save_kitti(pt, R, t)
        jtr.save_kitti(pj, R, t)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    load_t, load_j = (ttr.load_tum, jtr.load_tum) if fmt == "tum" else \
        (ttr.load_kitti, jtr.load_kitti)
    for x, y in zip(load_t(pj), load_j(pt)):
        np.testing.assert_array_equal(x, y)


def test_rpe():
    R, t = _poses(seed=1)
    R2, t2 = _poses(seed=2)
    for d in (1, 3, 20):
        np.testing.assert_allclose(ttr.rpe_rmse(R, t, R2, t2, delta=d),
                                   jtr.rpe_rmse(R, t, R2, t2, delta=d), atol=1e-12)


def test_evaluate_ate_cli(tmp_path):
    """tests/test_dataset_native.py::test_evaluate_ate_cli's case through
    both scripts, with and without --no_scale and --verbose: the same
    output."""
    rng = np.random.default_rng(0)
    t = np.arange(80) * 0.05
    p = np.stack([np.sin(t), np.cos(t), 0.1 * t], 1)

    def write(path, t, p, scale=1.0):
        with open(path, "w") as f:
            for i in range(len(t)):
                x = scale * p[i]
                f.write(f"{t[i]:.6f} {x[0]} {x[1]} {x[2]} 0 0 0 1\n")

    gt, est = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    write(gt, t, p)
    write(est, t + 0.001, p + rng.normal(0, 0.005, p.shape), scale=0.5)
    for flags in ([], ["--no_scale"], ["--verbose"]):
        outs = [subprocess.run([sys.executable, os.path.join(REPO, script), gt, est, *flags],
                               capture_output=True, text=True, check=True).stdout
                for script in ("evaluation/evaluate_ate_scale.py",
                               "rover_slam_tpu_torch/apps/evaluate_ate_scale.py")]
        assert outs[0] == outs[1] and outs[0]
    out = subprocess.run([sys.executable, "-m", "rover_slam_tpu_torch.apps.evaluate_ate_scale",
                          gt, est], capture_output=True, text=True, check=True,
                         cwd=REPO).stdout
    rmse, scale = (float(x) for x in out.strip().split(","))
    assert abs(scale - 2.0) < 0.05
    assert rmse < 0.02
