"""Stereo-inertial SLAM of the port against the JAX package
(rover_slam_tpu/slam/stereo_inertial.py: StereoInertialSLAM):
tests/test_stereo_inertial.py's scene (6000-landmark ring world,
orbit_with_imu at dt 0.1, 512 keypoints, 64-D, the right eye = the left
keypoints shifted by the true disparity at a 0.11 m baseline, tinit_s 1.0)
cut to N_FRAMES, a few frames past the IMU init (frame 10 on both sides),
through both systems. Held: equal tracking states on every frame, the IMU
initialized at the same frame, the same keyframe count, each fixed-scale
inertial-only solve's scale exactly 1 and its Rwg within 2e-4, bg within
1e-4 and ba within 1e-5 of the JAX package's (measured: 8e-5, 2.8e-5,
2e-8; the solves see keyframe poses a few 0.1 mm apart), the final bg
within 1e-4 and ba within 1e-3 (measured: 4e-5 and 3.9e-4, after the VI
refinements with the stereo row), camera centres within 3 mm (measured:
1.0 mm), and the port's stereo wiring: its VI refinements and VI-BAs get the
stereo inverse depths and bf (a VI-BA run on the final map for the latter: none falls due in
N_FRAMES). The monocular-inertial side of the same wiring:
tests/test_torch_inertial_mono_bf.py."""
import numpy as np
import jax.numpy as jnp
import pytest

from rover_slam_tpu.imu import preintegration as jpre
from rover_slam_tpu.optim import inertial_init as jii
from rover_slam_tpu.slam.stereo_inertial import StereoInertialSLAM as JaxSI
from rover_slam_tpu_torch.optim import inertial_init as tii, pose_inertial as tpio
from rover_slam_tpu_torch.optim import vi_ba as tvib
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.slam.stereo_inertial import StereoInertialSLAM as TorchSI
from rover_slam_tpu_torch.utils import synthetic

from torch_parity import IMU_CALIB, _np

N_FRAMES = 15
BASELINE = 0.11


def si_scene(n_frames):
    """The scene's frames, the right-eye keypoints of each and the IMU."""
    world = synthetic.ring_world(n_landmarks=6000, desc_dim=64, seed=0)
    R_gt, t_gt, times, _, imu = synthetic.orbit_with_imu(n_frames=40, revs=0.4, dt=0.1)
    frames = synthetic.render_sequence(world, R_gt[:n_frames], t_gt[:n_frames],
                                       times[:n_frames], n_kpts=512, pix_noise=0.5,
                                       desc_noise=0.05)
    fx = float(np.asarray(world.cam_params)[0])
    right = []
    for f in frames:
        Xc = (f.R_cw @ world.landmarks[np.maximum(f.lm_id, 0)].T).T + f.t_cw
        depth = np.where(f.lm_id >= 0, Xc[:, 2], -1.0)
        kpts_r = f.kpts.copy()
        kpts_r[:, 0] -= np.where(depth > 0, fx * BASELINE / np.maximum(depth, 1e-3), 0)
        right.append(kpts_r)
    return world, frames, right, imu


class _Spy:
    """Records the stereo fields of every problem a constructor builds."""

    def __init__(self, monkeypatch, mod, name, fields):
        orig = getattr(mod, name)
        self.seen = []

        def build(*a, **k):
            prob = orig(*a, **k)
            self.seen.append(tuple(getattr(prob, f) for f in fields))
            return prob

        monkeypatch.setattr(mod, name, build)


@pytest.fixture(scope="module")
def runs():
    world, frames, right, imu = si_scene(N_FRAMES)
    calib = jpre.ImuCalib(**{k: jnp.asarray(v) for k, v in IMU_CALIB.items()})
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, cls, mod, kw in (("jax", JaxSI, jii, {}),
                                   ("torch", TorchSI, tii, dict(device="cpu"))):
            solves = []
            orig = mod.inertial_only_optimization

            def recording(*a, orig=orig, solves=solves, **k):
                res = orig(*a, **k)
                solves.append(tuple(_np(x) for x in (res.scale, res.Rwg, res.bg, res.ba)))
                return res

            mp.setattr(mod, "inertial_only_optimization", recording)
            if name == "torch":
                spies = (_Spy(mp, tpio, "PoseInertialProblem", ("invd", "bf")),)
            slam = cls(world.cam_params, calib, BASELINE, tinit_s=1.0,
                       map_capacity=(64, 512, 16384), desc_dim=64, **kw)
            states, ready = [], None
            for i, (f, kpts_r) in enumerate(zip(frames, right)):
                if i > 0:
                    for a, g, t in zip(*imu[i - 1]):
                        slam.feed_imu(a, g, t)
                states.append(int(slam.track_stereo_frame(f.kpts, f.rays, f.desc, f.valid,
                                                          kpts_r, f.desc, f.valid,
                                                          f.time)["state"]))
                if slam.imu_ready and ready is None:
                    ready = i
            e_t, e_R, e_tcw = slam.get_trajectory()
            out[name] = dict(slam=slam, states=states, ready=ready, solves=solves,
                             pos=np.stack([-e_R[i].T @ e_tcw[i] for i in range(len(e_t))]))
            mp.undo()
        out["spies"] = spies
    finally:
        mp.undo()
    return out


def test_stereo_inertial_parity(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["states"] == j["states"] and set(j["states"]) == {int(tT.OK)}
    assert t["ready"] == j["ready"] is not None and j["ready"] < N_FRAMES - 2
    ts, js = t["slam"], j["slam"]
    assert ts.n_kf == js.n_kf and ts.imu_ready and js.imu_ready
    assert len(t["solves"]) == len(j["solves"]) >= 1
    for st, sj in zip(t["solves"], j["solves"]):
        assert st[0] == sj[0] == 1.0
        np.testing.assert_allclose(st[1], sj[1], rtol=0, atol=2e-4)
        np.testing.assert_allclose(st[2], sj[2], rtol=0, atol=1e-4)
        np.testing.assert_allclose(st[3], sj[3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(ts.bg), _np(js.bg), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(ts.ba), _np(js.ba), rtol=0, atol=1e-3)
    assert t["pos"].shape == j["pos"].shape == (N_FRAMES, 3)
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=0, atol=3e-3)
    assert ts.vi_refines > 0


def test_stereo_rows_reach_inertial_solvers(runs, monkeypatch):
    """The run's VI refinements got the frames' stereo inverse depths and
    bf; a temporal-window VI-BA on its final map gets the keyframes'."""
    poses, = runs["spies"]
    slam = runs["torch"]["slam"]
    bf = slam.bf
    assert bf == pytest.approx(BASELINE * float(slam.cam_params[0]))
    assert poses.seen and all(invd is not None and float(b) == np.float32(bf)
                              for invd, b in poses.seen)
    assert any(bool((invd > 0).any()) for invd, _ in poses.seen)
    vibas = _Spy(monkeypatch, tvib, "VIBAProblem", ("e_invd", "bf"))
    runs_before = slam.vi_ba_runs
    slam._run_vi_ba()
    assert slam.vi_ba_runs == runs_before + 1
    (e_invd, b), = vibas.seen
    assert float(b) == np.float32(bf) and bool((e_invd > 0).any())
