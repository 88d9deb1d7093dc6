"""The port stands alone: no module of rover_slam_tpu_torch/ (nor
chip_smoke.py, profile_port.py or tests/test_torch_cuda.py) imports JAX,
Flax, Optax or the JAX package, its entry points default to the card, and
what it has not ported raises."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from rover_slam_tpu_torch.slam.system import MonocularSLAM
from rover_slam_tpu_torch.slam.tracking import TrackerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rover_slam_tpu")
CAM = np.asarray([458.0, 458.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)


def _port_files():
    files = sorted((ROOT / "rover_slam_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "profile_port.py", ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    return files


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_name_matching():
    assert _forbidden("rover_slam_tpu.ops.association") and _forbidden("jax.numpy")
    assert not _forbidden("rover_slam_tpu_torch.ops") and not _forbidden("jaxtyping_like")


def test_port_never_imports_jax_or_the_jax_package():
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in _port_files()
           for m in _imported_modules(p) if _forbidden(m)]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert MonocularSLAM(CAM, device=None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MonocularSLAM(CAM, device=None)
    assert MonocularSLAM(CAM, device="cpu").state.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(enable_loop_closing=True), dict(pipeline=4),
                                dict(pipeline=True), dict(mesh=object()),
                                dict(config=TrackerConfig(kf_cull_every=4))])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        MonocularSLAM(CAM, device="cpu", **kw)


def test_timestamp_jump_raises_instead_of_degrading():
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=0)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=10, dt=0.1, speed=0.6,
                                                     yaw_rate=0.04)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512,
                                       pix_noise=0.4, desc_noise=0.05)
    slam = MonocularSLAM(world.cam_params, map_capacity=(32, 512, 4096), desc_dim=64,
                         device="cpu")
    for f in frames:
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.n_kf >= 2
    f = frames[-1]
    with pytest.raises(NotImplementedError, match="Atlas"):
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time + 5.0)
