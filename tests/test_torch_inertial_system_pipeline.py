"""Both MonocularInertialSLAMs with pipeline=4 on the scene of
tests/test_torch_inertial_system.py, 41 frames: the finish, keyframe
decision and insert of each frame run four frames after its dispatch (the
inserts stay on the host, _fused_mapping_ok is False).

The JAX package's pipelined inertial path loses tracking about 20 frames
after the IMU init (ROADMAP.md, section C): both packages report
RECENTLY_LOST at the same calls (39 and 40 here). Tracking thins after the
init (inliers fall from ~240 at frame 25 to ~20 at frame 30), and from
frame 27 on the map follows rounding: the port alone, at 1 against 8 torch
threads, moves its keyframes by 44 mm there. So the checks of the
synchronous scene (torch_parity.check_inertial_pair) hold the keyframes as
they stood after frame 26, centres within 3 cm and metric ATEs within 1 cm
of each other (measured over world seeds 0-2 at 1 and 8 torch threads: at
most 3.7 mm and 0.06 cm), and the rest over the first 36 frames. The run
stops before relocalization's random draws (the JAX package's PRNG against
a torch.Generator) could part the two."""
import pytest

from torch_parity import check_inertial_pair, inertial_pair

RECENTLY_LOST = 3


@pytest.fixture(scope="module")
def runs():
    return inertial_pair(41, pipeline=4, n_scored=36, snap_frame=26)


def test_inertial_system_pipelined(runs):
    check_inertial_pair(runs[0], pos_atol=0.03)
    for name in ("jax", "torch"):
        assert runs[0][name]["states"][39:] == [RECENTLY_LOST, RECENTLY_LOST], name
