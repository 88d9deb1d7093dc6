"""The port stands alone: no module of rover_slam_tpu_torch/ (nor
chip_smoke.py, profile_port.py or tests/test_torch_cuda.py) imports JAX,
Flax, Optax or the JAX package, its entry points default to the card, and
what it has not ported raises (loop closing, the multi-device BA)."""
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


@pytest.mark.parametrize("kw", [dict(enable_loop_closing=True), dict(mesh=object())])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        MonocularSLAM(CAM, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(pipeline=4), dict(pipeline=True),
                                dict(config=TrackerConfig(kf_cull_every=4))])
def test_lifecycle_options_are_ported(kw):
    """pipeline=K and keyframe culling build a system (their parity tests are
    tests/test_torch_system_*.py); without a card, cuda still raises."""
    slam = MonocularSLAM(CAM, device="cpu", **kw)
    assert slam.pipeline_depth == (4 if "pipeline" in kw else 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MonocularSLAM(CAM, device=None, **kw)
