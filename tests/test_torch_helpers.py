"""The four small public helpers of the JAX package that the port lacked
until it ported its benchmark scripts: slam/system.py frame_inliers, optim/robust.py
cauchy_weight, geometry/lie.py se3_matrix and geometry/triangulation.py
reprojection_error2, each against the JAX function on the same numpy
inputs (float32; tolerances in each test)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rover_slam_tpu.geometry import cameras as jcam, lie as jlie, triangulation as jtri
from rover_slam_tpu.optim import robust as jrob
from rover_slam_tpu.slam import system as jsys
from rover_slam_tpu_torch.geometry import cameras as tcam, lie as tlie, triangulation as ttri
from rover_slam_tpu_torch.optim import robust as trob
from rover_slam_tpu_torch.slam import system as tsys


@pytest.mark.parametrize("idx", [None, [], [-1, -1], [3, -1, 0, 7, -1]])
def test_frame_inliers(idx):
    arr = None if idx is None else np.asarray(idx, np.int32)
    fj = SimpleNamespace(landmark_idx=None if arr is None else jnp.asarray(arr))
    ft = SimpleNamespace(landmark_idx=None if arr is None else torch.from_numpy(arr))
    assert tsys.frame_inliers(ft) == jsys.frame_inliers(fj)
    assert isinstance(tsys.frame_inliers(ft), int)


@pytest.mark.parametrize("delta2", [5.991, 0.5])
def test_cauchy_weight(delta2):
    chi2 = np.random.default_rng(0).exponential(4.0, (3, 50)).astype(np.float32)
    chi2[0, :3] = 0.0
    np.testing.assert_allclose(trob.cauchy_weight(torch.from_numpy(chi2), delta2).numpy(),
                               np.asarray(jrob.cauchy_weight(jnp.asarray(chi2), delta2)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("shapes", [((3, 3), (3,)), ((5, 3, 3), (5, 3)), ((2, 4, 3, 3), (2, 4, 3))])
def test_se3_matrix(shapes):
    rng = np.random.default_rng(1)
    R = rng.normal(size=shapes[0]).astype(np.float32)
    t = rng.normal(size=shapes[1]).astype(np.float32)
    out = tlie.se3_matrix(torch.from_numpy(R), torch.from_numpy(t))
    ref = np.asarray(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(t)))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_reprojection_error2():
    """Through each package's pinhole projection: equal within 1e-6
    relative (the division's rounding)."""
    rng = np.random.default_rng(2)
    cam = np.asarray([458.0, 457.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)
    Xc = np.c_[rng.normal(size=(64, 2)), rng.uniform(2, 9, 64)].astype(np.float32)
    uv = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    camt = torch.from_numpy(cam)
    out = ttri.reprojection_error2(lambda X: tcam.project(tcam.PINHOLE, camt, X),
                                   torch.from_numpy(Xc), torch.from_numpy(uv))
    ref = jtri.reprojection_error2(lambda X: jcam.project(jcam.PINHOLE, jnp.asarray(cam), X),
                                   jnp.asarray(Xc), jnp.asarray(uv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-3)
