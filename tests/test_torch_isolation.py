"""The port stands alone: no module of rover_slam_tpu_torch/ (nor
chip_smoke.py, profile_port.py, probe_history.py or tests/test_torch_cuda.py)
imports JAX, Flax, Optax or the JAX package, its shipped codebooks are plain
arrays, its entry points default to the card, and what it has not ported
raises naming its slice (the multi-device BA)."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from rover_slam_tpu_torch.imu import preintegration
from rover_slam_tpu_torch.map import keyframe_database, maintenance
from rover_slam_tpu_torch.slam.inertial_system import MonocularInertialSLAM
from rover_slam_tpu_torch.slam.loop_closing import LoopCloser, LoopConfig
from rover_slam_tpu_torch.slam.system import MonocularSLAM
from rover_slam_tpu_torch.slam.tracking import TrackerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rover_slam_tpu")
CAM = np.asarray([458.0, 458.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)


def _port_files():
    files = sorted((ROOT / "rover_slam_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "profile_port.py", ROOT / "probe_history.py",
        ROOT / "tests" / "test_torch_cuda.py"]
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


def test_loop_closing_modules_are_covered():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for m in ("slam/loop_closing.py", "map/keyframe_database.py", "optim/sim3_solver.py",
              "optim/pose_graph.py", "utils/config.py", "slam/host_copy.py"):
        assert "rover_slam_tpu_torch/" + m in names, m


def test_codebook_asset_holds_plain_arrays():
    """The shipped codebooks load without pickle (nothing of JAX or of the
    JAX package inside), one [D, 2048] float32 array per entry."""
    with np.load(keyframe_database.ASSET, allow_pickle=False) as z:
        assert sorted(z.files) == ["d256_w2048_s3", "d64_w2048_s3"]
        for k in z.files:
            a = z[k]
            assert a.dtype == np.float32 and a.shape == (int(k[1:k.index("_")]), 2048)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert MonocularSLAM(CAM, device=None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MonocularSLAM(CAM, device=None)
    assert MonocularSLAM(CAM, device="cpu").state.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(mesh=object(), enable_loop_closing=True),
                                dict(mesh=object())])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        MonocularSLAM(CAM, device="cpu", **kw)


def test_loop_path_variants_raise():
    """mesh= (multi-device, A17) raises on the loop path; stereo bf (A16
    steps a-c) is taken, as a float32 scalar on the closer's device (its
    parity: tests/test_torch_stereo.py::test_loop_closer_welding_ba_with_bf)."""
    with pytest.raises(NotImplementedError, match="A17"):
        LoopCloser(CAM, 8, 64, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A17"):
        MonocularSLAM(CAM, device="cpu", mesh=object())
    lc = LoopCloser(CAM, 8, 64, config=LoopConfig(), device="cpu")
    assert lc.bf is None and lc._bf_arr() is None and lc.pose_graph_mode == "sim3"
    lc.bf = 400.0
    assert lc._bf_arr().dtype == torch.float32 and float(lc._bf_arr()) == 400.0
    slam = MonocularSLAM(CAM, device="cpu", map_capacity=(8, 16, 64))
    with pytest.raises(NotImplementedError, match="A17"):
        maintenance.global_ba(slam.state, slam.cam_params, mesh=object())


@pytest.mark.parametrize("kw", [dict(pipeline=4), dict(pipeline=True),
                                dict(config=TrackerConfig(kf_cull_every=4)),
                                dict(pipeline=4, enable_loop_closing=True,
                                     loop_config=LoopConfig(min_covis_weight=30))])
def test_lifecycle_options_are_ported(kw):
    """pipeline=K, keyframe culling and loop closing build a system (their
    parity tests are tests/test_torch_system_*.py and
    tests/test_torch_loop_*.py); without a card, cuda still raises."""
    slam = MonocularSLAM(CAM, device="cpu", **kw)
    assert slam.pipeline_depth == (4 if "pipeline" in kw else 0)
    assert (slam.loop_closer is not None) == ("enable_loop_closing" in kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MonocularSLAM(CAM, device=None, **kw)


CALIB = preintegration.ImuCalib(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                0.0024, 0.028, 1.3e-6, 2.1e-4)


def test_inertial_modules_are_covered():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for m in ("imu/preintegration.py", "optim/pose_inertial.py", "optim/inertial_init.py",
              "optim/vi_ba.py", "slam/inertial_system.py"):
        assert "rover_slam_tpu_torch/" + m in names, m


def test_inertial_system_entry_point():
    """MonocularInertialSLAM defaults to the card; its inserts stay on the
    host; its loop closer starts in the Sim3 mode (4-DoF once the IMU is
    aligned); it takes stereo inputs: bf set turns into a float32 scalar
    on the system's device (slam/stereo_inertial.py sets it)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MonocularInertialSLAM(CAM, CALIB, device=None)
    slam = MonocularInertialSLAM(CAM, CALIB, device="cpu", enable_loop_closing=True,
                                 pipeline=4)
    assert slam.calib.Rbc.device.type == "cpu" and not slam._fused_mapping_ok()
    assert slam.cfg.time_recently_lost_s == 5.0 and not slam.cfg.insert_kfs_when_lost
    lc = slam.loop_closer
    assert lc.pose_graph_mode == "sim3"
    lc.use_4dof = True
    assert lc.pose_graph_mode == "4dof"
    assert slam.bf is None and slam._bf_arr() is None
    slam.bf = 400.0
    assert slam._bf_arr().dtype == torch.float32 and float(slam._bf_arr()) == 400.0


def test_stereo_modules_are_covered():
    """The stereo modules are port files this test scans."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for m in ("geometry/rectify.py", "slam/stereo.py", "slam/stereo_inertial.py"):
        assert "rover_slam_tpu_torch/" + m in names, m


def test_io_modules_are_covered():
    """The persistence, config, dataset and app modules (A14) are port files
    this test scans; the native loader is the port's own copy."""
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for m in ("map/atlas.py", "utils/config.py", "utils/dataset.py", "utils/trajectory.py",
              "utils/synthetic.py", "models/superpoint.py", "models/lightglue.py",
              "apps/run_euroc.py", "apps/evaluate_ate_scale.py"):
        assert "rover_slam_tpu_torch/" + m in names, m
    assert (ROOT / "rover_slam_tpu_torch" / "native" / "dataset_loader.cc").exists()


def test_app_entry_point_defaults_to_cuda():
    """run_euroc runs on the card unless --device cpu is given."""
    from rover_slam_tpu_torch.apps import run_euroc
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_euroc.main(["settings.yaml", "mav0"])
