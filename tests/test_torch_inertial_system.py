"""Both MonocularInertialSLAMs, synchronous, on tests/test_e2e_inertial.py's
ring world at a small size (64-D descriptors, 512 keypoints, 44 frames at
dt 0.1, tinit_s=1.5): the same tracking state on every frame, the IMU
initialized at the same frame with the same scale, gravity rotation and
biases, and the same metric trajectory (tolerances in
torch_parity.check_inertial_pair; positions within 3 cm over a 5 m orbit)."""
import numpy as np
import pytest

from torch_parity import check_inertial_pair, inertial_pair


@pytest.fixture(scope="module")
def runs():
    return inertial_pair(44)


def test_inertial_system_sync(runs):
    check_inertial_pair(runs[0], pos_atol=0.03)


def test_inertial_system_state(runs):
    """Keyframe body states after the init: velocities metric (the orbit's
    ~3 m/s), both sides' within 0.1 m/s; the loop-free map holds no 4-DoF
    switch without a loop closer."""
    t, j = runs[0]["torch"]["slam"], runs[0]["jax"]["slam"]
    assert t.n_kf == j.n_kf and t.loop_closer is None
    k = slice(t._kf_base, t.n_kf)
    np.testing.assert_allclose(t.state.kf_v_wb[k].numpy(), np.asarray(j.state.kf_v_wb[k]),
                               atol=0.1)
    assert 1.0 < float(np.linalg.norm(t.v_wb.numpy())) < 6.0
