"""Fisheye (KannalaBrandt8) stereo of the port against the JAX package
(rover_slam_tpu/slam/stereo.py: fisheye_stereo_match_kernel,
FisheyeStereoMixin, FisheyeStereoSLAM), on tests/test_fisheye_stereo.py's
TUM-VI-like rig (KB8 at 512x512, R_rl = exp([0, 0.02, 0]),
t_rl = [-0.101, 0.002, 0.001]; chip_smoke.fisheye_rig and the scene
builders beside it, which path J2 drives on the card):
- the match on that test's single-frame inputs: the match sets may part only
  on near-ties of the bf16 descriptor products (ROADMAP.md §C), so at least
  99 % of each side's stereo points are the other's too, with the same right
  keypoint (measured: all 386 the same). There the triangulated points
  agree within 2e-4 x (distance / baseline) relative: the DLT solves f32
  normal equations whose condition grows as (distance / baseline)^2, and
  XLA and torch round its sums differently (measured: 1.1e-4 x, 1.3 % at
  13 m on the 0.10 m baseline). Both recover the true depth to a median 5 %
  (the JAX test's gate);
- both FisheyeStereoSLAMs over that test's 30-frame scene
  (chip_smoke.fisheye_stereo_scene) cut to N_FRAMES:
  equal tracking states on every frame, stereo points per frame within 2
  (the near-ties), camera centres within 4 mm (measured: 2.9 mm over 30
  frames; the pose solves see a few different stereo rows), the same
  keyframe count, and both metric ATEs (Horn without scale) under the JAX
  test's 10 cm;
- the app's call convention on a fisheye rig (ROADMAP.md §C, matched, not
  mended): the JAX app hands the right eye's pixels to track_stereo_frame,
  which takes unit rays; the [N, 2] pixels break the bearing-space epipolar
  gate's division by the third coordinate in both packages, on the first
  frame, before the init."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import cameras as jcam
from rover_slam_tpu.slam import stereo as jst
from rover_slam_tpu.slam import tracking as jT
from rover_slam_tpu_torch.slam import stereo as tst
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.utils import synthetic, trajectory

import chip_smoke
import torch_parity  # noqa: F401  (one torch thread per xdist worker)

N_FRAMES = 12
KB8, R_RL, T_RL = chip_smoke.fisheye_rig()


def _frames_pair():
    """tests/test_fisheye_stereo.py::test_fisheye_match_recovers_metric_depth's
    frames: the left camera at the origin, the right through the rig."""
    world = chip_smoke.fisheye_world(3)
    kw = dict(n_kpts=512, pix_noise=0.02, desc_noise=0.03)
    fl = synthetic.render_frame(world, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                0.0, seed=11, **kw)
    fr = synthetic.render_frame(world, R_RL, T_RL, 0.0, seed=12, **kw)
    return world, fl, fr


def test_fisheye_match_parity():
    world, fl, fr = _frames_pair()
    args = (fl.rays, fl.desc, fl.valid, fr.rays, fr.desc, fr.valid, R_RL,
            T_RL)
    mj, Xj, okj = (np.asarray(x) for x in jst.fisheye_stereo_match_kernel(
        *(jnp.asarray(a) for a in args)))
    mt, Xt, okt = (x.numpy() for x in tst.fisheye_stereo_match_kernel(
        *(torch.from_numpy(np.asarray(a)) for a in args)))
    both = okj & okt & (mj == mt)
    assert okj.sum() > 100
    assert both.sum() >= 0.99 * max(okj.sum(), okt.sum()), (okj.sum(), okt.sum(), both.sum())
    dist = np.linalg.norm(Xj[both], axis=1)
    rel = np.linalg.norm(Xt[both] - Xj[both], axis=1) / dist
    assert (rel <= 2e-4 * dist / np.linalg.norm(T_RL)).all(), rel.max()
    lm = fl.lm_id
    gt_depth = np.asarray(world.landmarks)[np.clip(lm, 0, len(world.landmarks) - 1)][:, 2]
    for X, ok in ((Xj, okj), (Xt, okt)):
        sel = ok & (lm >= 0)
        assert np.median(np.abs(X[sel, 2] - gt_depth[sel]) / gt_depth[sel]) < 0.05


def _system(mod, T, **kw):
    return mod.FisheyeStereoSLAM(KB8, (R_RL, T_RL),
                                 config=T.TrackerConfig(cam_kind=jcam.KANNALA_BRANDT8,
                                                        image_hw=(512, 512)),
                                 map_capacity=(64, 512, 16384), desc_dim=64, **kw)


@pytest.fixture(scope="module")
def runs():
    left, right, (R_gt, t_gt, times), _ = chip_smoke.fisheye_stereo_scene(N_FRAMES)
    gt = np.stack([-R.T @ t for R, t in zip(R_gt, t_gt)])
    out = {}
    for name, mod, T, kw in (("jax", jst, jT, {}), ("torch", tst, tT, dict(device="cpu"))):
        slam = _system(mod, T, **kw)
        states, n_depth = [], []
        for fl, fr in zip(left, right):
            states.append(int(slam.track_stereo_frame(fl.kpts, fl.rays, fl.desc, fl.valid,
                                                      fr.rays, fr.desc, fr.valid,
                                                      fl.time)["state"]))
            n_depth.append(int((np.asarray(slam._stereo_depth) > 0).sum()))
        e_t, e_R, e_tcw = slam.get_trajectory()
        pos = np.stack([-e_R[i].T @ e_tcw[i] for i in range(len(e_t))])
        out[name] = dict(states=states, n_depth=n_depth, pos=pos, n_kf=int(slam.n_kf),
                         ate=trajectory.ate_rmse(pos, gt[-len(pos):], with_scale=False)[0])
    return out


def test_fisheye_stereo_slam_parity(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["states"] == j["states"] and j["states"][-1] == int(tT.OK)
    assert np.abs(np.subtract(t["n_depth"], j["n_depth"])).max() <= 2
    assert min(j["n_depth"]) >= 100
    assert t["pos"].shape == j["pos"].shape == (N_FRAMES, 3)
    np.testing.assert_allclose(t["pos"], j["pos"], rtol=0, atol=4e-3)
    assert t["n_kf"] == j["n_kf"] >= 2
    assert j["ate"] < 0.10 and t["ate"] < 0.10, (j["ate"], t["ate"])


def test_app_convention_on_fisheye_rig():
    """One fisheye frame with the right eye's pixels where rays belong (the
    JAX app's call): both systems fail in the epipolar gate on the first
    frame and stay uninitialized."""
    _, fl, fr = _frames_pair()
    for mod, T, kw, err in ((jst, jT, {}, TypeError),
                            (tst, tT, dict(device="cpu"), RuntimeError)):
        slam = _system(mod, T, **kw)
        with pytest.raises(err, match="broadcast|must match"):
            slam.track_stereo_frame(fl.kpts, fl.rays, fl.desc, fl.valid, fr.kpts, fr.desc,
                                    fr.valid, 0.0)
        assert slam.tracking_state == T.NO_IMAGES_YET and slam.n_kf == 0
        # The rays the mixin expects give a metric init at once.
        info = slam.track_stereo_frame(fl.kpts, fl.rays, fl.desc, fl.valid, fr.rays, fr.desc,
                                       fr.valid, 0.0)
        assert info["init"] and slam.n_kf == 1
