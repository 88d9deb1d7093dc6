"""Back end of the port (pose optimization, two-view init, Schur BA, map
state, maintenance, track step, keyframe insert) against the JAX package on
identical inputs. Tolerances: poses atol 1e-4, points atol 1e-3, integer
tables exact."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import lie as jlie, two_view as jtv
from rover_slam_tpu.map import map_state as jms, maintenance as jmnt
from rover_slam_tpu.optim import ba as jba, pose_opt as jpo
from rover_slam_tpu.slam import tracking as jT
from rover_slam_tpu_torch.geometry import two_view as ttv
from rover_slam_tpu_torch.map import map_state as tms, maintenance as tmnt
from rover_slam_tpu_torch.optim import ba as tba, pose_opt as tpo
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.slam.system import MonocularSLAM
from rover_slam_tpu_torch.utils import synthetic

from torch_parity import (CAM, POSE, POINT, _np, assert_states_match,  # noqa: E402
                          from_jax_state, jax_problem, to_jax_state)


@pytest.fixture(scope="module")
def scene():
    """A map built by the port on the synthetic world, stopped before frame
    12, plus that frame and the motion-model prediction for it."""
    world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=0)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=14, dt=0.1, speed=0.6,
                                                     yaw_rate=0.04)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512,
                                       pix_noise=0.4, desc_noise=0.05)
    slam = MonocularSLAM(world.cam_params, map_capacity=(32, 512, 4096), desc_dim=64,
                         device="cpu")
    for f in frames[:12]:
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.n_kf >= 3
    R0, t0 = slam._predict_pose()
    return slam, frames[12], R0, t0


def test_pose_optimization():
    rng = np.random.default_rng(0)
    M = 300
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(3, 15, M)],
                 1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.005], jnp.float32)))
    t = np.asarray([0.05, -0.02, 0.1], np.float32)
    Xc = X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:] * CAM[:2] + CAM[2:4]).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:30] += rng.uniform(-40, 40, (30, 2)).astype(np.float32)      # outliers
    valid = rng.uniform(size=M) > 0.05
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.zeros(3, np.float32)
    for kw in (dict(), dict(rounds=2, iters_per_round=5, check_cost=False)):
        rj = jpo.pose_optimization(*(jnp.asarray(a) for a in (R0, t0, X, uv, valid, CAM)), **kw)
        rt = tpo.pose_optimization(*(torch.from_numpy(a) for a in (R0, t0, X, uv, valid, CAM)),
                                   **kw)
        np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), **POSE)
        np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), **POSE)
        np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
        assert int(rt.n_inliers) == int(rj.n_inliers)


def test_two_view_reconstruct_with_injected_samples():
    """reconstruct on the JAX package's own 400 draws. A draw that repeats a
    match gives a rank-7 [8, 9] system whose 8-point fit (both packages read
    row 7 of its SVD) is any vector of a 2-D null space, so LAPACK's rounding
    picks it: on these inputs 71 of 400 such hypotheses differ between the
    runtimes, one of them leads the port's scores, and the two RANSAC winners
    part (0.26 and 0.31 degrees from the truth). What is defined is held:
    every hypothesis of 8 distinct matches (E up to sign atol 1e-4, its
    inlier flags away from the chi2 gate, its score within 0.5 plus 2.15 for
    each match near the gate); the LO refit, model selection and triangulation on
    the JAX package's leaders and inliers (POSE, points 1e-3); and both whole
    results against the truth (rotation within 0.5 degree; translation
    direction within 10 degrees, measured 6.2 for the JAX package and 1.5
    for the port over this 0.5 m baseline at 5-15 m; >= 120 of the 140
    matches triangulated)."""
    rng = np.random.default_rng(60)
    M = 150
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(5, 15, M)],
                 1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    t = np.asarray([0.5, 0.05, 0.1], np.float32)
    X2 = X @ R.T + t
    x1 = (X[:, :2] / X[:, 2:3] + rng.normal(0, 0.001, (M, 2))).astype(np.float32)
    x2 = (X2[:, :2] / X2[:, 2:3] + rng.normal(0, 0.001, (M, 2))).astype(np.float32)
    mask = np.ones(M, bool)
    mask[140:] = False
    key = jax.random.PRNGKey(0)
    res_j = jtv.reconstruct(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), key)
    # The JAX package's own draws (reconstruct's first split + weighted choice).
    _, k1 = jax.random.split(key)
    p = jnp.asarray(mask, jnp.float32) / mask.sum()
    samples = np.asarray(jax.random.choice(k1, M, shape=(400, 8), replace=True, p=p))
    x1t, x2t, mt = torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask)
    res_t = ttv.reconstruct(x1t, x2t, mt, samples=torch.tensor(samples))

    # Hypotheses and their scores.
    sigma2 = 0.0022 ** 2
    xs1, xs2 = jnp.asarray(x1[samples]), jnp.asarray(x2[samples])
    E_j = jax.jit(jax.vmap(jtv._eight_point_E))(xs1, xs2)
    e1, e2 = jax.vmap(lambda E: jtv._epi_chi2(E, jnp.asarray(x1), jnp.asarray(x2), sigma2))(E_j)
    mj = jnp.asarray(mask)
    scores_j = np.asarray(jnp.sum((jnp.where(e1 < jtv.CHI2_F, jtv.CHI2_H - e1, 0.0)
                                   + jnp.where(e2 < jtv.CHI2_F, jtv.CHI2_H - e2, 0.0))
                                  * mj, axis=1))
    inl_j = (e1 < jtv.CHI2_F) & (e2 < jtv.CHI2_F) & mj
    E_t = ttv._eight_point_E(torch.from_numpy(x1[samples]), torch.from_numpy(x2[samples]))
    e1t, e2t = ttv._epi_chi2(E_t, x1t, x2t, sigma2)
    scores_t = (torch.sum((torch.where(e1t < ttv.CHI2_F, ttv.CHI2_H - e1t, 0.0)
                           + torch.where(e2t < ttv.CHI2_F, ttv.CHI2_H - e2t, 0.0))
                          * mt.float(), dim=1)).numpy()
    distinct = np.array([len(set(s)) == 8 for s in samples])
    assert distinct.sum() >= 300
    unit = lambda E: E / np.linalg.norm(E, axis=(1, 2), keepdims=True)  # noqa: E731
    Ej, Et = unit(np.asarray(E_j))[distinct], unit(E_t.numpy())[distinct]
    sign = np.sign(np.sum(Ej * Et, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(Et * sign, Ej, atol=1e-4, rtol=0)
    # A match whose chi2 lies within 5 % of the gate may cross it, which moves
    # the score by up to CHI2_H - CHI2_F = 2.15; elsewhere the per-match terms
    # differ by under 0.16 in chi2 (measured: the worst-conditioned samples).
    near = np.zeros(samples.shape[0], np.int64)
    for ej, et in ((e1, e1t), (e2, e2t)):
        ej, et = np.asarray(ej), et.numpy()
        band = (np.abs(ej - jtv.CHI2_F) < 0.05 * jtv.CHI2_F) & mask
        near += band.sum(1)
        flip = ((ej < jtv.CHI2_F) != (et < jtv.CHI2_F)) & mask & ~band
        assert not flip[distinct].any()
    bound = 0.5 + (jtv.CHI2_H - jtv.CHI2_F) * near[distinct]
    assert np.all(np.abs(scores_t[distinct] - scores_j[distinct]) <= bound)

    # The refit and triangulation on the JAX package's leaders.
    _, top = jax.lax.top_k(jnp.asarray(scores_j), 8)
    top = np.asarray(top)
    H_j = jax.vmap(jtv._four_point_H)(xs1[:, :4], xs2[:, :4])
    h1, h2 = jax.vmap(lambda H: jtv._h_chi2(H, jnp.asarray(x1), jnp.asarray(x2), sigma2))(H_j)
    sH = jnp.sum((jnp.where(h1 < jtv.CHI2_H, jtv.CHI2_H - h1, 0.0)
                  + jnp.where(h2 < jtv.CHI2_H, jtv.CHI2_H - h2, 0.0)) * mj, axis=1)
    bH = int(jnp.argmax(sH))
    use_H = bool(sH[bH] / max(float(sH[bH]) + float(scores_j.max()), 1e-9) > 0.45)
    assert use_H == bool(res_j.used_homography)
    sel = ttv.select_motion(x1t, x2t, mt, torch.from_numpy(np.asarray(E_j)[top]),
                            torch.from_numpy(np.asarray(inl_j)[top]),
                            torch.from_numpy(np.asarray(H_j[bH])),
                            torch.from_numpy(np.asarray((h1[bH] < jtv.CHI2_H)
                                                        & (h2[bH] < jtv.CHI2_H) & mj)),
                            torch.tensor(use_H), sigma2, min_inliers=50)
    assert bool(sel.success) == bool(res_j.success) is True
    np.testing.assert_allclose(sel.R_21.numpy(), np.asarray(res_j.R_21), **POSE)
    np.testing.assert_allclose(sel.t_21.numpy(), np.asarray(res_j.t_21), **POSE)
    tri = np.asarray(res_j.is_triangulated)
    np.testing.assert_array_equal(sel.is_triangulated.numpy(), tri)
    np.testing.assert_allclose(sel.points3d.numpy()[tri], np.asarray(res_j.points3d)[tri],
                               atol=1e-3, rtol=1e-4)

    # Both whole results against the truth.
    t_dir = t / np.linalg.norm(t)
    for res in (res_t, res_j):
        assert bool(res.success) and not bool(res.used_homography)
        Rr, tr = np.asarray(res.R_21), np.asarray(res.t_21)
        ang = np.degrees(np.arccos(np.clip((np.trace(Rr.T @ R) - 1) / 2, -1, 1)))
        assert ang < 0.5
        assert np.degrees(np.arccos(np.clip(tr @ t_dir, -1, 1))) < 10.0
        assert 120 <= int(np.asarray(res.is_triangulated).sum()) <= 140


def test_singular_homography_hypothesis():
    """A minimal sample can give an exactly singular H (the JAX draws of
    tests/test_torch_app.py's init did): the port's transfer chi2 no longer
    raises, and its gate rejects what jnp.linalg.inv's non-finite inverse
    rejects in the JAX package."""
    rng = np.random.default_rng(3)
    x1 = rng.uniform(-0.5, 0.5, (40, 2)).astype(np.float32)
    x2 = (x1 + 0.01).astype(np.float32)
    H = np.asarray([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]], np.float32)
    ht = [a.numpy() for a in ttv._h_chi2(torch.from_numpy(H)[None], torch.from_numpy(x1),
                                         torch.from_numpy(x2), 0.0022 ** 2)]
    hj = [np.asarray(a) for a in jtv._h_chi2(jnp.asarray(H), jnp.asarray(x1),
                                             jnp.asarray(x2), 0.0022 ** 2)]
    for a, b in zip(ht, hj):
        np.testing.assert_array_equal(a[0] < jtv.CHI2_H, b < jtv.CHI2_H)
        np.testing.assert_array_equal(np.isfinite(a[0]), np.isfinite(b))


def test_solve_ba_schur(scene):
    """The keyframe insert's BA options (schur, direct reduced solve,
    kf-major edges, lm_cap) on a window of the scene's map."""
    slam, _, _, _ = scene
    st = slam.state
    window = torch.tensor([slam.n_kf - 1] + list(range(slam.n_kf - 1)) + [-1] * 3,
                          dtype=torch.int32)
    opt = torch.zeros(window.shape[0], dtype=torch.bool)
    opt[:2] = True
    prob_t = tT._ba_window_args(st, window, opt & (window != 0), torch.from_numpy(CAM))
    # Perturb so the solver has work to do.
    rng = np.random.default_rng(1)
    lm_pos = prob_t.lm_pos + torch.from_numpy(rng.normal(0, 0.01, prob_t.lm_pos.shape)
                                              .astype(np.float32))
    prob_t = prob_t._replace(lm_pos=lm_pos)
    prob_j = jax_problem(jba.BAProblem, prob_t)
    rj = jba.solve_ba(prob_j, iters=2, solver="schur", lm_cap=256, kf_major=True,
                      red_solver="direct")
    rt = tba.solve_ba(prob_t, iters=2, lm_cap=256)
    np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), **POSE)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), **POSE)
    np.testing.assert_allclose(rt.lm_pos.numpy(), np.asarray(rj.lm_pos), **POINT)
    np.testing.assert_array_equal(rt.e_inlier.numpy(), np.asarray(rj.e_inlier))


def test_map_state_ops(scene):
    slam, f, _, _ = scene
    st_t = slam.state
    st_j = to_jax_state(st_t)
    rng = np.random.default_rng(2)
    N = st_t.N
    Xw = rng.normal(size=(N, 3)).astype(np.float32)
    ok = rng.uniform(size=N) > 0.6
    nrm = Xw / np.linalg.norm(Xw, axis=1, keepdims=True)
    anchor = np.full(N, 2, np.int32)
    st_j, sl_j = jms.add_landmarks(st_j, *(jnp.asarray(a) for a in (Xw, f.desc, nrm, anchor, ok)))
    st_t, sl_t = tms.add_landmarks(st_t, *(torch.from_numpy(a) for a in
                                           (Xw, f.desc, nrm, anchor, ok)))
    np.testing.assert_array_equal(sl_t.numpy(), np.asarray(sl_j))
    lidx = np.where(ok, np.asarray(sl_j), -1).astype(np.int32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.1, 0.0], jnp.float32)))
    args = (R, np.ones(3, np.float32), f.kpts, f.rays, f.desc, f.valid, lidx)
    st_j, k_j = jms.add_keyframe(st_j, *(jnp.asarray(a) for a in args), 1.5, parent=2)
    st_t, k_t = tms.add_keyframe(st_t, *(torch.from_numpy(a) for a in args), 1.5, parent=2)
    assert int(k_t) == int(k_j)
    assert_states_match(st_t, st_j)
    obs_t = tms.observation_matrix(st_t)
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(jms.observation_matrix(st_j)))
    W_t, W_j = tms.covisibility(st_t), jms.covisibility(st_j)
    np.testing.assert_array_equal(W_t.numpy(), np.asarray(W_j))
    np.testing.assert_array_equal(tms.covisibility_row(st_t, 1).numpy(),
                                  np.asarray(jms.covisibility_row(st_j, 1)))
    for kf in range(int(k_j) + 1):
        ids_t, w_t = tms.best_covisible(W_t, kf, 3)
        ids_j, w_j = jms.best_covisible(W_j, kf, 3)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    kill = rng.uniform(size=st_t.L) > 0.7
    assert_states_match(tms.remove_landmarks(st_t, torch.from_numpy(kill)),
                        jms.remove_landmarks(st_j, jnp.asarray(kill)))


def test_maintenance_subset(scene):
    slam, _, _, _ = scene
    st_t = slam.state
    st_j = to_jax_state(st_t)
    kf = slam.n_kf - 1
    cam_t, cam_j = torch.from_numpy(CAM), jnp.asarray(CAM)
    st_t, nf_t, na_t = tmnt.fuse_into_keyframe(st_t, torch.tensor(kf), cam_t)
    st_j, nf_j, na_j = jmnt.fuse_into_keyframe(st_j, jnp.asarray(kf, jnp.int32), cam_j)
    assert (int(nf_t), int(na_t)) == (int(nf_j), int(na_j))
    assert_states_match(st_t, st_j)
    st_t = tmnt.update_distinctive_descriptors(st_t, torch.tensor(kf))
    st_j = jmnt.update_distinctive_descriptors(st_j, jnp.asarray(kf, jnp.int32))
    assert_states_match(st_t, st_j)
    rng = np.random.default_rng(3)
    vis = rng.uniform(size=st_t.L) > 0.5
    found = vis & (rng.uniform(size=st_t.L) > 0.5)
    st_t = tmnt.update_found_visible(st_t, torch.from_numpy(vis), torch.from_numpy(found))
    st_j = jmnt.update_found_visible(st_j, jnp.asarray(vis), jnp.asarray(found))
    st_t = tmnt.cull_landmarks(tmnt.recount_lm_obs(st_t))
    st_j = jmnt.cull_landmarks(jmnt.recount_lm_obs(st_j))
    assert_states_match(st_t, st_j)


def _track_args(slam, f):
    prev = slam.last_frame
    return (prev.desc, prev.valid, prev.landmark_idx, torch.from_numpy(f.kpts),
            torch.from_numpy(f.desc), torch.from_numpy(f.valid))


@pytest.mark.parametrize("local_map_only", [False, True])
def test_track_step(scene, local_map_only):
    slam, f, R0, t0 = scene
    cfg = slam.cfg
    args = _track_args(slam, f)
    ref_kf = slam.n_kf - 1
    common = (cfg.cam_kind, cfg.image_hw, cfg.min_matches_motion, cfg.min_inliers_track,
              cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2)
    out_t = tT._track_step_body(slam.state, *args, R0, t0, slam.cam_params, *common,
                                ref_kf=torch.tensor(ref_kf, dtype=torch.int32),
                                local_map_only=local_map_only)
    out_j = jT._track_step_kernel(to_jax_state(slam.state),
                                  *(jnp.asarray(a.numpy()) for a in args),
                                  jnp.asarray(R0.numpy()), jnp.asarray(t0.numpy()),
                                  jnp.asarray(CAM), *common,
                                  ref_kf=jnp.asarray(ref_kf, jnp.int32),
                                  local_map_only=local_map_only)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), **POSE)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), **POSE)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    assert int(out_t[3][0]) == 1


def test_track_step_reference_keyframe_fallback(scene):
    """A useless motion-model match (no previous landmarks) sends the frame
    through the reference-keyframe branch."""
    slam, f, R0, t0 = scene
    cfg = slam.cfg
    prev_desc, prev_valid, prev_lidx, kp, de, va = _track_args(slam, f)
    no_lidx = torch.full_like(prev_lidx, -1)
    common = (cfg.cam_kind, cfg.image_hw, cfg.min_matches_motion, cfg.min_inliers_track,
              cfg.min_inliers_local_map, cfg.proj_radius, cfg.desc_th2)
    ref_kf = slam.n_kf - 1
    out_t = tT._track_step_body(slam.state, prev_desc, prev_valid, no_lidx, kp, de, va,
                                R0, t0, slam.cam_params, *common,
                                ref_kf=torch.tensor(ref_kf, dtype=torch.int32))
    out_j = jT._track_step_kernel(to_jax_state(slam.state),
                                  *(jnp.asarray(a.numpy()) for a in
                                    (prev_desc, prev_valid, no_lidx, kp, de, va)),
                                  jnp.asarray(R0.numpy()), jnp.asarray(t0.numpy()),
                                  jnp.asarray(CAM), *common,
                                  ref_kf=jnp.asarray(ref_kf, jnp.int32))
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    assert int(out_t[3][2]) == 1      # stage 1 recovered through the reference KF
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), **POSE)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


def test_map_state_from_jax_fields(scene):
    """The JAX MapState's fields (its inertial, stereo and loop-edge fields
    included) rebuild the port's map exactly, dtypes too; since the stereo
    field kf_kpt_invd came over, the two packages have the same fields."""
    st_t = scene[0].state
    st_j = to_jax_state(st_t)
    assert {f.name for f in dataclasses.fields(st_j)} == set(tms.FIELDS)
    back = from_jax_state(st_j)
    for k in tms.FIELDS:
        a, b = getattr(back, k), getattr(st_t, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert torch.equal(a, b), k


def test_insert_keyframe(scene):
    """Both sides insert into one map: the JAX state, and the port's rebuilt
    from its fields."""
    slam, f, R0, t0 = scene
    cfg = slam.cfg
    args = _track_args(slam, f)
    R, t, lidx, flags = tT._track_step_body(
        slam.state, *args, R0, t0, slam.cam_params, cfg.cam_kind, cfg.image_hw,
        cfg.min_matches_motion, cfg.min_inliers_track, cfg.min_inliers_local_map,
        cfg.proj_radius, cfg.desc_th2, ref_kf=torch.tensor(slam.n_kf - 1, dtype=torch.int32))
    frame = (R, t, torch.from_numpy(f.kpts), torch.from_numpy(f.rays),
             torch.from_numpy(f.desc), torch.from_numpy(f.valid), lidx)
    st_j_in = to_jax_state(slam.state)
    st_t, sc_t, mask_t = tT._insert_keyframe_body(
        from_jax_state(st_j_in), *frame, f.time, slam.n_kf - 1, slam.cam_params,
        cfg.cam_kind, cfg.local_window, cfg.fixed_window, cfg.ba_iters)
    st_j, sc_j, mask_j = jT._insert_keyframe_kernel(
        st_j_in, *(jnp.asarray(a.numpy()) for a in frame),
        jnp.asarray(f.time, jnp.float32), jnp.asarray(slam.n_kf - 1, jnp.int32),
        jnp.asarray(CAM), cfg.cam_kind, cfg.local_window, cfg.fixed_window, cfg.ba_iters)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    assert int(sc_t[1]) + int(sc_t[2]) > 0          # triangulated something
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert_states_match(st_t, st_j)


def test_association_ops(scene):
    """project_landmarks, desc_dist2, projection_match (scalar and per-landmark
    radius), fuse_duplicates, invert_matches and epipolar_gate on the scene's
    map and next frame."""
    from rover_slam_tpu.ops import association as jas
    from rover_slam_tpu_torch.ops import association as tas
    slam, f, R0, t0 = scene
    st = slam.state
    lm_pos, lm_desc, active = st.lm_pos.numpy(), st.lm_desc.numpy(), st.lm_active.numpy()
    uv_t, d_t, vis_t = tas.project_landmarks(*(torch.from_numpy(a) for a in (
        lm_pos, active, R0.numpy(), t0.numpy(), CAM)))
    uv_j, d_j, vis_j = jas.project_landmarks(*(jnp.asarray(a) for a in (
        lm_pos, active, R0.numpy(), t0.numpy(), CAM)))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    # bf16 products: a sum landing on a rounding boundary may round one bf16
    # step apart in the two runtimes (at most 2 * 2^-8 in 2 - 2 cos), rarely.
    dd = np.abs(tas.desc_dist2(torch.from_numpy(lm_desc[:300]), torch.from_numpy(f.desc))
                .numpy() - np.asarray(jas.desc_dist2(jnp.asarray(lm_desc[:300]),
                                                     jnp.asarray(f.desc))))
    assert dd.max() <= 2.0 ** -7 and (dd > 0).mean() < 1e-3
    uv = np.asarray(uv_j)
    vis = np.asarray(vis_j)
    radii = np.where(np.arange(len(vis)) % 2 == 0, 15.0, 7.5).astype(np.float32)
    for radius in (15.0, radii):
        kt, mt = tas.projection_match(*(torch.from_numpy(np.asarray(a)) for a in (
            uv, lm_desc, vis, f.kpts, f.desc, f.valid, radius)))
        kj, mj = jas.projection_match(*(jnp.asarray(a) for a in (
            uv, lm_desc, vis, f.kpts, f.desc, f.valid)), radius=jnp.asarray(radius))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert (kt.numpy() >= 0).sum() > 50
    ft = tas.fuse_duplicates(*(torch.from_numpy(a) for a in (
        uv, lm_desc, vis, f.kpts, f.desc, f.valid)))
    fj = jas.fuse_duplicates(*(jnp.asarray(a) for a in (
        uv, lm_desc, vis, f.kpts, f.desc, f.valid)), None)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    rng = np.random.default_rng(4)
    m = np.where(rng.uniform(size=512) > 0.3, rng.permutation(512), -1).astype(np.int32)
    np.testing.assert_array_equal(tas.invert_matches(torch.from_numpy(m), 512).numpy(),
                                  np.asarray(jas.invert_matches(jnp.asarray(m), 512)))
    kf = slam.state.kf_rays.numpy()
    R01 = (slam.state.kf_R_cw[1] @ slam.state.kf_R_cw[0].T).numpy()
    t01 = (slam.state.kf_t_cw[1] - torch.from_numpy(R01) @ slam.state.kf_t_cw[0]).numpy()
    np.testing.assert_array_equal(
        tas.epipolar_gate(*(torch.from_numpy(a) for a in (kf[1], kf[0], m, R01, t01))).numpy(),
        np.asarray(jas.epipolar_gate(*(jnp.asarray(a) for a in (kf[1], kf[0], m, R01, t01)))))


def test_segment_sums_match_the_one_hot_contraction():
    """seg_sum (entries sorted by segment, each segment summed in entry
    order) against the JAX package's one-hot seg_add; out-of-range indices
    drop; a plan over (segment, sub-key) keys also serves the coarser
    segments through every Kw-th offset, as optim/ba.py uses it."""
    from rover_slam_tpu.ops import scatterless as jsl
    from rover_slam_tpu_torch.ops import scatterless as tsl
    rng = np.random.default_rng(5)
    n, size, Kw = 3000, 257, 4
    idx = rng.integers(-3, size + 3, n).astype(np.int32)
    vals = rng.normal(size=(n, 3, 2)).astype(np.float32)
    out_t = tsl.seg_add(torch.from_numpy(idx), torch.from_numpy(vals), size)
    out_j = jsl.seg_add(jnp.asarray(idx), jnp.asarray(vals), size)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-6)
    assert torch.equal(out_t, tsl.seg_add(torch.from_numpy(idx), torch.from_numpy(vals), size))
    sub = rng.integers(0, Kw, n)
    key = torch.from_numpy(np.where(idx >= 0, idx.astype(np.int64) * Kw + sub, -1))
    plan = tsl.segment_plan(key, size * Kw)
    coarse = tsl.SegmentPlan(plan.order, plan.offsets[::Kw])
    np.testing.assert_allclose(tsl.seg_sum(coarse, torch.from_numpy(vals)).numpy(),
                               np.asarray(out_j), atol=1e-5, rtol=1e-6)
    fine = tsl.seg_sum(plan, torch.from_numpy(vals)).reshape(size, Kw, 3, 2)
    np.testing.assert_allclose(fine.sum(1).numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-6)
