"""The live loop with a mesh: the port's MonocularSLAM(mesh=make_mesh(2))
on tests/test_torch_loop_system.py's loop scene (the ring world, 70 frames,
tables 128 / 512 / 8192, LoopConfig(min_covis_weight=20)), against the same
system without a mesh. Until the loop fires the mesh changes nothing, so
the loop event must be the same and every pose logged before it equal to
the bit; after it the global BA runs landmark-sharded over the two shards
(maintenance.global_ba(mesh=)) and the trajectory must stay as good."""
import numpy as np
import pytest

from rover_slam_tpu_torch.parallel import sharded_ba
from rover_slam_tpu_torch.slam import tracking as T
from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
from rover_slam_tpu_torch.slam.system import MonocularSLAM

from torch_parity import ate, ring_orbit_frames


def _run(mesh):
    """The scene frame by frame; returns (slam, trajectory length before the
    frame that fired the first loop)."""
    world, frames, gt = ring_orbit_frames()
    slam = MonocularSLAM(world.cam_params, map_capacity=(128, 512, 8192), desc_dim=64,
                         enable_loop_closing=True, config=T.TrackerConfig(local_map_only=True),
                         loop_config=LoopConfig(min_covis_weight=20), mesh=mesh, device="cpu")
    n_before = None
    for f in frames:
        n_traj = len(slam.trajectory)
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
        if n_before is None and slam.loop_events:
            n_before = n_traj
    slam.flush()
    return slam, n_before, gt


@pytest.fixture(scope="module")
def runs():
    mesh = sharded_ba.make_mesh(2, device="cpu")
    return {"mesh": _run(mesh), "single": _run(None)}


def test_mesh_is_plumbed(runs):
    slam, _, _ = runs["mesh"]
    assert slam.mesh is slam.loop_closer.mesh and slam.mesh.size == 2
    assert runs["single"][0].loop_closer.mesh is None


def test_same_loop_fires(runs):
    (sm, nm, _), (ss, ns, _) = runs["mesh"], runs["single"]
    assert sm.loop_events and ss.loop_events and nm == ns
    (kf_m, info_m), (kf_s, info_s) = sm.loop_events[0], ss.loop_events[0]
    assert kf_m == kf_s
    for k in ("candidate", "query_kf", "n_inliers", "scale", "n_fused", "pg_cost"):
        assert info_m[k] == info_s[k], k
    assert sm.loop_closer._gba_pending == 0


def test_poses_before_the_fire_equal_to_the_bit(runs):
    (sm, n, _), (ss, _, _) = runs["mesh"], runs["single"]
    assert n > 30
    for a, b in zip(sm.trajectory[:n], ss.trajectory[:n]):
        assert a[0] == b[0] and a[3] == b[3]
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
        np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))


def test_trajectory_after_the_sharded_gba(runs):
    """tests/test_torch_loop_system.py's gates hold with the mesh."""
    (sm, _, gt), (ss, _, _) = runs["mesh"], runs["single"]
    assert sm.tracking_state == T.OK
    a_m, a_s = ate(sm, *gt), ate(ss, *gt)
    assert a_m < 0.05, (a_m, a_s)
