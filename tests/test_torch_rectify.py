"""Stereo rectification of the port (rover_slam_tpu_torch/geometry/rectify.py)
against the JAX package's, on tests/test_rectify.py's mildly misaligned
EuRoC-like rig (the right camera 1 degree off, radtan distortion on both
eyes):
- the maps on an already rectified rig: identity rotation, flat rows;
- epipolar alignment and depth: the rectified keypoints of both packages
  within 1e-3 px, rows aligned to sub-pixel, depth from disparity within
  0.5 % of the truth;
- remap against rectify_points: the remapped image of both packages within
  1e-5 (bilinear weights in f32), the dots landing at the rectified points;
- the unrectified end-to-end scene (12 frames) through both StereoSLAMs:
  the same tracking states, keyframe count and keyframe poses within 1e-4,
  and the metric path length within 10 % of the truth on both.
The maps are held within 2e-3 px of the JAX package's: both build them in
f64 numpy from an f32 half rotation (each package's own so3_exp/log)."""
import numpy as np
import jax.numpy as jnp
import torch

from rover_slam_tpu.geometry import cameras as jcam, rectify as jrect
from rover_slam_tpu.slam import stereo as jst, tracking as jT
from rover_slam_tpu.utils import synthetic
from rover_slam_tpu_torch.geometry import cameras as tcam, rectify as trect
from rover_slam_tpu_torch.slam import stereo as tst, tracking as tT

from test_rectify import D1, D2, HW, K1, K2, R_21, T_21, _raw_project


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _maps_both(*args):
    rj = jrect.stereo_rectify_maps(*args)
    rt = trect.stereo_rectify_maps(*args)
    for f in ("map1", "map2"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), rtol=0, atol=2e-3,
                                   err_msg=f)
    for f in ("K_new", "R1", "R2"):
        np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), rtol=0, atol=1e-6,
                                   err_msg=f)
    assert abs(rt.bf_px - rj.bf_px) < 1e-6 * rj.bf_px
    return rt


def _rect_both(uv, K, D, R, K_new):
    pj = np.asarray(jrect.rectify_points(*(jnp.asarray(np.asarray(a, np.float32))
                                           for a in (uv, K, D, R, K_new))))
    pt = trect.rectify_points(*(_t(a) for a in (uv, K, D, R, K_new))).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-3)
    return pt


def test_maps_identity_when_already_rectified():
    rr = _maps_both(K1, np.zeros(4), K1, np.zeros(4), np.eye(3), np.array([-0.11, 0.0, 0.0]),
                    HW)
    assert np.allclose(rr.R1, np.eye(3), atol=1e-6)
    assert np.abs(np.diff(rr.map1[:, :, 1], axis=1)).max() < 1e-3


def test_epipolar_alignment_and_depth():
    rng = np.random.default_rng(3)
    X = rng.uniform([-2, -1.5, 3.0], [2, 1.5, 8.0], (500, 3))
    uv1_raw = _raw_project(X, K1, D1)
    uv2_raw = _raw_project(X @ R_21.T + T_21, K2, D2)
    rr = _maps_both(K1, D1, K2, D2, R_21, T_21, HW)
    uv1 = _rect_both(uv1_raw, K1, D1, rr.R1, rr.K_new)
    uv2 = _rect_both(uv2_raw, K2, D2, rr.R2, rr.K_new)
    drow = np.abs(uv1[:, 1] - uv2[:, 1])
    assert np.median(drow) < 0.1 and drow.max() < 0.6, drow.max()
    depth = rr.bf_px / np.maximum(uv1[:, 0] - uv2[:, 0], 1e-6)
    z = (X @ np.asarray(rr.R1).T)[:, 2]
    assert np.median(np.abs(depth - z) / z) < 0.005
    # The undistortion inverts the distortion (8 fixed-point iterations leave
    # up to 2.2e-5 at the corners of a 640x480 view).
    xy = _t(rng.uniform(-0.5, 0.5, (200, 2)))
    back = trect.radtan_distort(trect.radtan_undistort(xy, _t(D1)), _t(D1))
    np.testing.assert_allclose(back.numpy(), xy.numpy(), atol=5e-5)


def test_remap_consistent_with_point_rectification():
    rr = _maps_both(K1, D1, K2, D2, R_21, T_21, HW)
    X = np.array([[0.5, -0.2, 4.0], [-0.8, 0.4, 6.0], [0.1, 0.6, 3.2]])
    uv_raw = _raw_project(X, K1, D1)
    img = np.zeros(HW, np.float32)
    for u, v in uv_raw:
        img[int(round(v)), int(round(u))] = 1.0
    img += np.random.default_rng(4).uniform(0, 0.1, HW).astype(np.float32)
    out_j = np.asarray(jrect.remap(jnp.asarray(img), jnp.asarray(rr.map1)))
    out_t = trect.remap(torch.from_numpy(img), torch.from_numpy(rr.map1)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    rgb = np.stack([img, 1 - img, img * 0.5], -1)
    np.testing.assert_allclose(
        trect.remap(torch.from_numpy(rgb), torch.from_numpy(rr.map1)).numpy(),
        np.asarray(jrect.remap(jnp.asarray(rgb), jnp.asarray(rr.map1))), rtol=0, atol=1e-5)
    for u, v in _rect_both(uv_raw, K1, D1, rr.R1, rr.K_new):
        ui, vi = int(round(u)), int(round(v))
        assert out_t[max(vi - 2, 0):vi + 3, max(ui - 2, 0):ui + 3].max() > 0.15, (u, v)


def test_unrectified_stereo_tracks_e2e():
    """tests/test_rectify.py's unrectified scene: raw distorted observations
    in both physical cameras, feature-space rectification, then each
    package's StereoSLAM on the rectified keypoints (the port's own
    rectify_points and unproject on its side)."""
    world = synthetic.make_world(n_landmarks=4000, desc_dim=32, seed=5)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=12, dt=0.1, speed=0.5)
    rr = _maps_both(K1, D1, K2, D2, R_21, T_21, HW)
    cam_new = np.asarray(jcam.make_pinhole(*rr.K_new), np.float32)
    baseline = float(rr.bf_px / rr.K_new[0])
    slams = {
        "jax": jst.StereoSLAM(cam_new, baseline=baseline, map_capacity=(32, 512, 8192),
                              desc_dim=32,
                              config=jT.TrackerConfig(min_init_matches=30, image_hw=HW)),
        "torch": tst.StereoSLAM(cam_new, baseline=baseline, map_capacity=(32, 512, 8192),
                                desc_dim=32, device="cpu",
                                config=tT.TrackerConfig(min_init_matches=30, image_hw=HW))}
    states = {k: [] for k in slams}
    rng = np.random.default_rng(0)
    pos, desc, N = np.asarray(world.landmarks), np.asarray(world.desc), 512
    for i in range(len(times)):
        Xl = pos @ R_gt[i].T + t_gt[i]
        Xr = Xl @ R_21.T + T_21
        vis = (Xl[:, 2] > 0.5) & (Xr[:, 2] > 0.5)
        uvl = _raw_project(np.where(vis[:, None], Xl, 1.0), K1, D1)
        uvr = _raw_project(np.where(vis[:, None], Xr, 1.0), K2, D2)
        inb = vis & np.all((uvl > 5) & (uvl < (635, 475)) & (uvr > 5) & (uvr < (635, 475)), 1)
        ids = rng.permutation(np.nonzero(inb)[0])[:N]
        n = len(ids)
        kl, kr = np.zeros((N, 2), np.float32), np.zeros((N, 2), np.float32)
        dl = np.zeros((N, desc.shape[1]), np.float32)
        valid = np.zeros((N,), bool)
        kl[:n] = uvl[ids] + rng.normal(0, 0.3, (n, 2))
        kr[:n] = uvr[ids] + rng.normal(0, 0.3, (n, 2))
        dl[:n] = desc[ids] + rng.normal(0, 0.05, (n, desc.shape[1]))
        dl /= np.maximum(np.linalg.norm(dl, axis=1, keepdims=True), 1e-9)
        valid[:n] = True
        for name, slam in slams.items():
            if name == "jax":
                kl_r = jrect.rectify_points(*(jnp.asarray(np.asarray(a, np.float32))
                                              for a in (kl, K1, D1, rr.R1, rr.K_new)))
                kr_r = jrect.rectify_points(*(jnp.asarray(np.asarray(a, np.float32))
                                              for a in (kr, K2, D2, rr.R2, rr.K_new)))
                rays = jcam.unproject_jit(jcam.PINHOLE, jnp.asarray(cam_new), kl_r)
                d = jnp.asarray(dl)
                info = slam.track_stereo_frame(kl_r, rays, d, jnp.asarray(valid), kr_r, d,
                                               jnp.asarray(valid), times[i])
            else:
                kl_r = trect.rectify_points(*(_t(a) for a in (kl, K1, D1, rr.R1, rr.K_new)))
                kr_r = trect.rectify_points(*(_t(a) for a in (kr, K2, D2, rr.R2, rr.K_new)))
                rays = tcam.unproject(tcam.PINHOLE, _t(cam_new), kl_r)
                d = torch.from_numpy(dl)
                info = slam.track_stereo_frame(kl_r, rays, d, torch.from_numpy(valid), kr_r,
                                               d, torch.from_numpy(valid), times[i])
            states[name].append(int(info["state"]))
    assert states["torch"] == states["jax"] and states["torch"][-1] == jT.OK
    st, sj = slams["torch"].state, slams["jax"].state
    assert slams["torch"].n_kf == slams["jax"].n_kf >= 2
    act = np.asarray(sj.kf_active)
    np.testing.assert_allclose(st.kf_R_cw.numpy()[act], np.asarray(sj.kf_R_cw)[act], atol=1e-4)
    np.testing.assert_allclose(st.kf_t_cw.numpy()[act], np.asarray(sj.kf_t_cw)[act], atol=1e-4)
    pos_gt = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    d_gt = np.linalg.norm(pos_gt[-1] - pos_gt[0])
    for slam in slams.values():
        est_t, est_R, est_tcw = slam.get_trajectory()
        p = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
        assert abs(np.linalg.norm(p[-1] - p[0]) - d_gt) / d_gt < 0.1
