"""Stereo and RGB-D of the port against the JAX package
(rover_slam_tpu/slam/stereo.py without its fisheye parts):
- stereo_match_kernel on tests/test_map_extras.py's inputs (rectified depth,
  the row gate): the same matches, depths within 1e-5 relative;
- _spawn_stereo_landmarks_kernel on a map the port's StereoSLAM built:
  every integer field equal, the new landmarks' positions and normals
  within 1e-6 (one rounding of the camera-to-world transform);
- tests/test_map_extras.py's TestStereoSLAM scene (25 frames, 512
  keypoints, 64-D) through both packages' systems (its TestRGBD scene:
  tests/test_torch_rgbd.py, with these helpers):
  equal tracking states on every frame, and the metric path length (no
  scale alignment) within 8 % of the truth on both. The maps are held
  whole as they stand after SNAP frames (the stereo scene's third keyframe,
  the RGB-D scene's second): every integer field equal, keyframe poses
  within torch_parity's POSE (1e-4), landmarks within POINT (1e-3) plus
  2e-4 of their distance (the local BA moves a 26 m point of the RGB-D map
  by 2.9 mm between the runtimes, 1.1e-4 of its distance; the welding BA
  below an 18 m point by 2.5 mm, 1.4e-4), representative
  descriptors equivalent. At the next insert one observation parts (the
  stereo scene at frame 9: a representative-descriptor tie, ROADMAP.md §C,
  changes a fused association; the RGB-D scene at frame 12: one more
  tracked association in the port), every later landmark slot shifts by
  one, and after it the two maps are held by keyframe count (within one);
- global_ba with bf on the stereo map (the whole padded edge table, three
  iterations) with its landmarks moved by 3 cm and its keyframes by 1 cm of
  seeded noise: poses POSE, the same outlier observations dropped, the map
  pulled back to within 5 mm of where it was, landmarks within 8 m of the
  origin within POINT and every landmark within 1e-3 of its distance. A
  0.11 m baseline sees a 20 m point at 2.5 px of disparity: along its depth
  the PCG steps leave it where the rounding of 25 CG iterations puts it
  (measured: 11 mm at 15.8 m, 7.0e-4 of the distance). On the converged
  map itself the steps gain ~1e-6 of the cost, and which of them f32
  accepts is a coin toss;
- the stereo map's atlas from the JAX writer through the port's reader and
  back, every field equal."""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.map import atlas as jat, maintenance as jmnt
from rover_slam_tpu.slam import stereo as jst
from rover_slam_tpu.utils import synthetic
from rover_slam_tpu_torch.map import atlas as tat, maintenance as tmnt
from rover_slam_tpu_torch.slam import stereo as tst

from rover_slam_tpu_torch.map import map_state as tms
from torch_parity import (INT_FIELDS, POINT, POSE, _np, assert_desc_equivalent,
                          assert_states_equal, from_jax_state, to_jax_state)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _match_both(*args):
    mj, dj, sj = jst.stereo_match_kernel(*(jnp.asarray(a) for a in args))
    mt, dt, st = tst.stereo_match_kernel(*(torch.from_numpy(np.asarray(a)) for a in args))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    return mt, dt


def test_stereo_match_rectified_depth():
    rng = np.random.default_rng(90)
    fx, baseline, N = 458.654, 0.11, 64
    depth_true = rng.uniform(2, 20, N).astype(np.float32)
    xl = rng.uniform(100, 500, N).astype(np.float32)
    y = rng.uniform(50, 430, N).astype(np.float32)
    kpts_l = np.stack([xl, y], 1)
    kpts_r = np.stack([xl - fx * baseline / depth_true, y], 1).astype(np.float32)
    desc = _unit(rng, N, 32)
    ones = np.ones(N, bool)
    m, depth = _match_both(kpts_l, desc, ones, kpts_r, desc, ones, np.float32(fx * baseline))
    ok = m.numpy() == np.arange(N)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(depth.numpy()[ok], depth_true[ok], rtol=0.02)


def test_stereo_match_row_gate():
    rng = np.random.default_rng(91)
    N = 16
    kpts_l = np.stack([np.full(N, 300.0), np.arange(N) * 20.0], 1).astype(np.float32)
    kpts_r = kpts_l.copy()
    kpts_r[:, 1] += 8.0
    kpts_r[:, 0] -= 20.0
    desc = _unit(rng, N, 32)
    ones = np.ones(N, bool)
    m, _ = _match_both(kpts_l, desc, ones, kpts_r, desc, ones, np.float32(50.0))
    assert (m.numpy() == -1).all()
    # Within the row tolerance the same pairs match on both sides.
    kpts_r[:, 1] -= 7.0
    m, _ = _match_both(kpts_l, desc, ones, kpts_r, desc, ones, np.float32(50.0))
    assert (m.numpy() == np.arange(N)).all()


def _stereo_scene():
    world = synthetic.make_world(n_landmarks=4000, desc_dim=64, seed=3)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=25, dt=0.1, speed=0.5)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512, pix_noise=0.4,
                                       desc_noise=0.05)
    return world, frames, (R_gt, t_gt, times)


def _true_depth(world, f):
    Xc = (f.R_cw @ world.landmarks[np.maximum(f.lm_id, 0)].T).T + f.t_cw
    return np.where(f.lm_id >= 0, Xc[:, 2], -1.0)


def _path_error(slam, gt):
    R_gt, t_gt, times = gt
    est_t, est_R, est_tcw = slam.get_trajectory()
    est = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    L_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    L_gt = np.linalg.norm(np.diff(pos[-len(est):], axis=0), axis=1).sum()
    return abs(L_est - L_gt) / L_gt


SNAP = {"stereo": 8, "rgbd": 11}


def _snapshot(st):
    return {k: _np(getattr(st, k)).copy() for k in tms.FIELDS}


def _systems(cls_j, cls_t, cam, **kw):
    return {"jax": cls_j(cam, map_capacity=(48, 512, 8192), desc_dim=64, **kw),
            "torch": cls_t(cam, map_capacity=(48, 512, 8192), desc_dim=64, device="cpu", **kw)}


@pytest.fixture(scope="module")
def stereo_runs():
    """TestStereoSLAM's scene: the right eye is the left keypoints shifted by
    the true disparity."""
    world, frames, gt = _stereo_scene()
    baseline = 0.11
    fx = float(np.asarray(world.cam_params)[0])
    out = {}
    for name, slam in _systems(jst.StereoSLAM, tst.StereoSLAM, world.cam_params,
                               baseline=baseline).items():
        states, snap = [], None
        for i, f in enumerate(frames):
            d = _true_depth(world, f)
            kpts_r = f.kpts.copy()
            kpts_r[:, 0] -= np.where(d > 0, fx * baseline / np.maximum(d, 1e-3), 0)
            states.append(int(slam.track_stereo_frame(f.kpts, f.rays, f.desc, f.valid,
                                                      kpts_r, f.desc, f.valid,
                                                      f.time)["state"]))
            if i == SNAP["stereo"]:
                snap = _snapshot(slam.state)
        out[name] = dict(slam=slam, states=states, snap=snap, err=_path_error(slam, gt))
    return out


def _assert_points_close(p_t, p_j):
    """Landmarks within POINT plus 2e-4 of their distance (a local BA leaves
    far points of these maps 1.1e-4-1.4e-4 of their distance apart)."""
    dist = np.linalg.norm(p_j, axis=1, keepdims=True)
    assert (np.abs(p_t - p_j) <= POINT["atol"] + 2e-4 * dist).all()


def _assert_systems_agree(runs):
    t, j = runs["torch"], runs["jax"]
    assert t["states"] == j["states"] and t["states"][-1] == 2
    st, sj = (SimpleNamespace(**x["snap"]) for x in (t, j))
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(st, k), getattr(sj, k), err_msg=k)
    assert int(sj.n_kf) >= 2
    act = sj.kf_active
    np.testing.assert_allclose(st.kf_R_cw[act], sj.kf_R_cw[act], **POSE)
    np.testing.assert_allclose(st.kf_t_cw[act], sj.kf_t_cw[act], **POSE)
    np.testing.assert_array_equal(st.kf_kpt_invd, sj.kf_kpt_invd)
    lm = sj.lm_active
    _assert_points_close(st.lm_pos[lm], sj.lm_pos[lm])
    assert_desc_equivalent(st, sj)
    assert abs(t["slam"].n_kf - j["slam"].n_kf) <= 1
    for name in ("jax", "torch"):
        assert runs[name]["err"] < 0.08, (name, runs[name]["err"])


def test_stereo_slam_metric_from_first_frame(stereo_runs):
    _assert_systems_agree(stereo_runs)
    assert (stereo_runs["torch"]["slam"].state.kf_kpt_invd > 0).any()


def test_spawn_stereo_landmarks(stereo_runs):
    """The spawn on the port's stereo map after its last keyframe, with that
    keyframe's landmarks dropped so that every depth-bearing keypoint is
    free."""
    slam = stereo_runs["torch"]["slam"]
    st = slam.state
    k = int(st.n_kf) - 1
    st = st.replace(kf_landmark_idx=st.kf_landmark_idx.index_fill(
        0, torch.tensor([k]), -1))
    depth = slam._stereo_depth
    out_t = tst._spawn_stereo_landmarks_kernel(st, k, depth, torch.tensor(4.4))
    out_j = jst._spawn_stereo_landmarks_kernel(to_jax_state(st), jnp.asarray(k, jnp.int32),
                                               jnp.asarray(depth.numpy()),
                                               jnp.asarray(4.4, jnp.float32))
    assert int(out_t.n_lm) > int(st.n_lm)
    for k in tms.FIELDS:
        a, b = _np(getattr(out_t, k)), _np(getattr(out_j, k))
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_global_ba_with_bf(stereo_runs):
    slam = stereo_runs["torch"]["slam"]
    st, cam = slam.state, slam.cam_params
    rng = np.random.default_rng(5)
    kf_t = st.kf_t_cw.numpy().copy()
    kf_t[1:] += rng.normal(0, 0.01, kf_t[1:].shape).astype(np.float32)
    noisy = st.replace(
        lm_pos=st.lm_pos + torch.from_numpy(rng.normal(0, 0.03, st.lm_pos.shape)).float(),
        kf_t_cw=torch.from_numpy(kf_t))
    bf = 0.11 * float(cam[0])
    out_t = tmnt.global_ba(noisy, cam, iters=3, bf=torch.tensor(bf))
    out_j = jmnt.global_ba(to_jax_state(noisy), jnp.asarray(cam.numpy()), iters=3,
                           bf=jnp.asarray(bf, jnp.float32))
    act = _np(st.kf_active)
    np.testing.assert_allclose(out_t.kf_R_cw.numpy()[act], np.asarray(out_j.kf_R_cw)[act],
                               **POSE)
    np.testing.assert_allclose(out_t.kf_t_cw.numpy()[act], np.asarray(out_j.kf_t_cw)[act],
                               **POSE)
    lm = _np(st.lm_active)
    pj = np.asarray(out_j.lm_pos)[lm]
    dist = np.linalg.norm(pj, axis=1)
    diff = np.abs(out_t.lm_pos.numpy()[lm] - pj).max(1)
    assert (diff[dist < 8.0] <= POINT["atol"]).all() and (dist < 8.0).sum() > 25
    assert (diff <= 1e-3 * dist).all(), (diff / dist).max()
    np.testing.assert_array_equal(out_t.kf_landmark_idx.numpy(),
                                  np.asarray(out_j.kf_landmark_idx))
    back = np.abs(out_t.lm_pos.numpy()[lm] - st.lm_pos.numpy()[lm]).max(1).mean()
    assert back < 0.005, back


def test_stereo_atlas_round_trip(stereo_runs, tmp_path):
    st_j = stereo_runs["jax"]["slam"].state
    p = str(tmp_path / "stereo_jax.npz")
    jat.save_atlas(st_j, p)
    st_t = tat.load_atlas(p, device="cpu")
    assert_states_equal(st_t, st_j)
    assert bool((st_t.kf_kpt_invd > 0).any())
    p2 = str(tmp_path / "stereo_port.npz")
    tat.save_atlas(st_t, p2)
    assert_states_equal(st_t, jat.load_atlas(p2))
    assert_states_equal(from_jax_state(st_j), st_j)


def test_loop_closer_welding_ba_with_bf(stereo_runs):
    """The loop closer takes the stereo bf (the A16 refusal lifted): its
    welding BA on the stereo map, keyframes 0-2 as the absorbed side and the
    last keyframe as the query, against the JAX package's with the same bf
    (poses POSE, landmarks POINT, the same outlier observations dropped)."""
    from rover_slam_tpu.slam import loop_closing as jlc
    from rover_slam_tpu_torch.slam import loop_closing as tlc
    slam = stereo_runs["torch"]["slam"]
    st, cam = slam.state, slam.cam_params
    lc = tlc.LoopCloser(cam, st.K, 64, device="cpu")
    lc.bf = slam.bf
    n = int(st.n_kf)
    in_old = torch.arange(st.K) < 3
    out_t = tlc._welding_ba_kernel(st, n - 1, 1, cam, 0, 4, 3, in_old, bf=lc._bf_arr())
    out_j = jlc._welding_ba_kernel(to_jax_state(st), jnp.asarray(n - 1, jnp.int32),
                                   jnp.asarray(1, jnp.int32), jnp.asarray(cam.numpy()), 0, 4, 3,
                                   bf=jnp.asarray(slam.bf, jnp.float32),
                                   adjust_candidate_side=True,
                                   in_old=jnp.asarray(in_old.numpy()))
    act = _np(st.kf_active)
    for f in ("kf_R_cw", "kf_t_cw"):
        np.testing.assert_allclose(getattr(out_t, f).numpy()[act],
                                   np.asarray(getattr(out_j, f))[act], **POSE)
    lm = _np(st.lm_active)
    _assert_points_close(out_t.lm_pos.numpy()[lm], np.asarray(out_j.lm_pos)[lm])
    np.testing.assert_array_equal(out_t.kf_landmark_idx.numpy(),
                                  np.asarray(out_j.kf_landmark_idx))
    assert not torch.equal(out_t.kf_t_cw, st.kf_t_cw)
