"""Helpers shared by the port's parity tests (tests/test_torch_*.py): carry
a map between the port's MapState and the JAX package's, compare the two,
and build a mid-sequence map with the port."""
import contextlib
import dataclasses
import functools
import os

import numpy as np
import jax.numpy as jnp
import torch

from rover_slam_tpu.map import map_state as jms
from rover_slam_tpu_torch.map import map_state as tms

# pytest-xdist workers share the cores: torch in each would start one thread
# per core, and six workers on eight cores then oversubscribe the CPU many
# times over (the port's map-sized tensor ops run on every thread).
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

POSE = dict(atol=1e-4, rtol=0)
POINT = dict(atol=1e-3, rtol=0)
CAM = np.asarray([458.654, 457.296, 367.215, 248.375, 0, 0, 0, 0], np.float32)
INT_FIELDS = ("kf_landmark_idx", "kf_active", "kf_kpt_valid", "kf_parent", "lm_active",
              "lm_n_obs", "lm_found", "lm_visible", "lm_first_kf", "lm_anchor_kf",
              "n_kf", "n_lm", "lm_dropped")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def torch_problem(cls, prob_j):
    """The port's NamedTuple `cls` with the fields of a JAX one (extra JAX
    fields, such as the stereo ones left None, are dropped)."""
    return cls(**{f: torch.from_numpy(np.array(getattr(prob_j, f)))
                  for f in cls._fields if getattr(prob_j, f, None) is not None})


def jax_problem(cls, prob_t):
    """The JAX package's NamedTuple `cls` with the fields of a port one
    (fields left None, such as a mono problem's stereo ones, stay None)."""
    return cls(**{f: jnp.asarray(x.numpy()) for f, x in prob_t._asdict().items()
                  if x is not None})


def to_jax_state(st: tms.MapState):
    base = jms.empty_map(K=st.K, N=st.N, L=st.L, D=st.lm_desc.shape[1])
    return base.replace(**{k: jnp.asarray(getattr(st, k).numpy()) for k in tms.FIELDS})


def from_jax_state(st_j) -> tms.MapState:
    return tms.map_state_from_numpy({f.name: np.asarray(getattr(st_j, f.name))
                                     for f in dataclasses.fields(st_j)})


def assert_desc_equivalent(st_t, st_j):
    """Representative descriptors: where the two sides picked different
    observations, both picks must reach the same minimum median distance.
    Ties are common (every landmark observed twice has two equal medians) and
    the JAX package breaks them by the rounding of its pairwise distances."""
    dt, dj = _np(st_t.lm_desc), _np(st_j.lm_desc)
    li, kv = _np(st_j.kf_landmark_idx), _np(st_j.kf_kpt_valid) & _np(st_j.kf_active)[:, None]
    desc = _np(st_j.kf_desc)
    diff = np.nonzero(_np(st_j.lm_active) & (np.abs(dt - dj).max(1) > 1e-5))[0]
    for l in diff:
        obs = desc[(li == l) & kv]

        def med(x):
            return np.median(((obs - x) ** 2).sum(1))
        assert abs(med(dt[l]) - med(dj[l])) < 1e-5, l
        assert np.abs(obs - dt[l]).max(1).min() < 1e-6, l    # one of the observations
    return len(diff)


def assert_states_match(st_t: tms.MapState, st_j):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(st_t, k)), _np(getattr(st_j, k)), err_msg=k)
    act = _np(st_j.kf_active)
    np.testing.assert_allclose(_np(st_t.kf_R_cw)[act], _np(st_j.kf_R_cw)[act], **POSE)
    np.testing.assert_allclose(_np(st_t.kf_t_cw)[act], _np(st_j.kf_t_cw)[act], **POSE)
    lm = _np(st_j.lm_active)
    np.testing.assert_allclose(_np(st_t.lm_pos)[lm], _np(st_j.lm_pos)[lm], **POINT)
    assert_desc_equivalent(st_t, st_j)
    np.testing.assert_allclose(_np(st_t.lm_normal)[lm], _np(st_j.lm_normal)[lm], atol=1e-4)


def assert_states_equal(st_t: tms.MapState, st_j):
    """Every field of the port's MapState equals the JAX one, bit for bit."""
    for k in tms.FIELDS:
        a, b = _np(getattr(st_t, k)), _np(getattr(st_j, k))
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def synthetic_frames(n_frames, seed=0, n_kpts=512):
    """The JAX e2e tests' forward scene (3000 landmarks, 64-D descriptors)."""
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=seed)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=n_frames, dt=0.1, speed=0.6,
                                                     yaw_rate=0.04)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=n_kpts,
                                       pix_noise=0.4, desc_noise=0.05)
    return world, frames, (R_gt, t_gt, times)


def ate(slam, R_gt, t_gt, times, t_min=-np.inf, t_max=np.inf):
    """Scale-aligned ATE (m) of a system's trajectory over its frames logged
    in [t_min, t_max) (evaluate_ate_scale's protocol)."""
    from rover_slam_tpu.utils import trajectory
    est_t, est_R, est_tcw = slam.get_trajectory()
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times)
             if t_min <= est_t[i] < t_max and np.isfinite(est_pos[i]).all()]
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    return trajectory.ate_rmse(e, g, with_scale=True)[0]


def both_systems(cam_params, **kw):
    """The JAX package's MonocularSLAM and the port's (on the CPU), built
    alike: {"jax": ..., "torch": ...}."""
    from rover_slam_tpu.slam import tracking as jT
    from rover_slam_tpu.slam.system import MonocularSLAM as JaxSLAM
    from rover_slam_tpu_torch.slam import tracking as tT
    from rover_slam_tpu_torch.slam.system import MonocularSLAM as TorchSLAM
    cfg = kw.pop("config", None) or {}
    return {"jax": JaxSLAM(cam_params, config=jT.TrackerConfig(**cfg), **kw),
            "torch": TorchSLAM(cam_params, config=tT.TrackerConfig(**cfg), device="cpu", **kw)}


def feed(slam, frames, dt=0.0):
    """Track frames (time shifted by dt); returns the states track_frame
    reported."""
    return [slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time + dt)["state"]
            for f in frames]


def garbage_frames(n, t0, seed, n_kpts=512, dim=64, dt=0.1):
    """Unmatchable frames (random keypoints and descriptors), tests/
    test_e2e_mono.py's kidnap and LOST input."""
    from types import SimpleNamespace
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kpts = rng.uniform(20, 400, (n_kpts, 2)).astype(np.float32)
        desc = rng.normal(size=(n_kpts, dim)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        rays = np.concatenate([kpts * 0.001, np.ones((n_kpts, 1))], 1).astype(np.float32)
        out.append(SimpleNamespace(kpts=kpts, rays=rays, desc=desc,
                                   valid=np.ones(n_kpts, bool), time=t0 + dt * k))
    return out


COMPACTION_K = 16
COMPACTION_CFG = dict(kf_cull_every=3, kf_max_interval=4, min_init_matches=50,
                      min_inliers_local_map=12)


def run_compaction_scene(pipeline, n_frames):
    """Both systems through the compaction scene (tables 16 / 512 / 2048),
    counting compactions. Returns {name: dict(slam, states, compactions,
    ate)}."""
    world, frames, gt = synthetic_frames(n_frames)
    out = {}
    for name, slam in both_systems(world.cam_params,
                                   map_capacity=(COMPACTION_K, 512, 2048), desc_dim=64,
                                   config=COMPACTION_CFG, pipeline=pipeline).items():
        compactions = []
        compact = slam._compact_map

        def counted(compact=compact, compactions=compactions):
            compactions.append(1)
            compact()

        slam._compact_map = counted
        states = feed(slam, frames)
        slam.flush()
        out[name] = dict(slam=slam, states=states, compactions=len(compactions),
                         ate=ate(slam, *gt))
    return out


def check_compaction_scene(runs):
    for name in ("jax", "torch"):
        r = runs[name]
        slam, states = r["slam"], r["states"]
        first_ok = states.index(2)
        assert all(s in (2, None) for s in states[first_ok:]), name
        assert slam.tracking_state == 2, name
        assert slam._next_uid > COMPACTION_K >= slam.n_kf, (name, slam._next_uid)
        assert int(slam.state.lm_dropped) == 0, name
        assert r["compactions"] >= 2 and len(slam._kf_redirect) > 0, name
    t, j = runs["torch"], runs["jax"]
    assert t["ate"] < 0.2 and abs(t["ate"] - j["ate"]) < 0.01, (t["ate"], j["ate"])
    assert abs(t["slam"].n_kf - j["slam"].n_kf) <= 0.3 * j["slam"].n_kf
    assert abs(t["slam"]._next_uid - j["slam"]._next_uid) <= 0.3 * j["slam"]._next_uid


def ring_orbit_frames(n_frames=70, revs=1.25, n_kpts=512):
    """tests/test_loop_closing_e2e.py's loop scene: the ring world (6000
    landmarks, 64-D), an orbit that returns to its start."""
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.ring_world(n_landmarks=6000, desc_dim=64, seed=0)
    R_gt, t_gt, times = synthetic.orbit_trajectory(n_frames=n_frames, revs=revs)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=n_kpts,
                                       pix_noise=0.5, desc_noise=0.05)
    return world, frames, (R_gt, t_gt, times)


@functools.lru_cache(maxsize=1)
def _ring_orbit_fields(n_frames, n_kpts):
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    from rover_slam_tpu_torch.slam.tracking import TrackerConfig
    world, frames, _ = ring_orbit_frames(n_kpts=n_kpts)
    slam = MonocularSLAM(world.cam_params, map_capacity=(64, n_kpts, 8192), desc_dim=64,
                         config=TrackerConfig(local_map_only=True), device="cpu")
    feed(slam, frames[:n_frames])
    assert slam.tracking_state == 2
    return {k: getattr(slam.state, k).numpy().copy() for k in tms.FIELDS}


def ring_orbit_state(n_frames=62, n_kpts=512) -> tms.MapState:
    """The map the port builds (loop closing off) over the loop scene's
    first n_frames of 70 (1.25 revolutions), n_kpts keypoints a frame, on
    tables (64, n_kpts, 8192): at 62 its newest keyframe revisits the first
    ones."""
    return tms.map_state_from_numpy(_ring_orbit_fields(n_frames, n_kpts))


MERGE_DELTA = np.array([0.09, 0.0, -0.07], np.float32)   # tests/test_multisession.py


def warped_session(n_frames=32, revs=0.32, seed=9):
    """Session one over a ring arc, its map warped by MERGE_DELTA * ramp(kf id)
    (zero at the seam, full past keyframe 4), then session two's first
    frames tracked into a fresh map (times + 500 s)."""
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    from rover_slam_tpu_torch.slam.tracking import TrackerConfig
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.ring_world(n_landmarks=6000, desc_dim=64, seed=seed)
    R_gt, t_gt, times = synthetic.orbit_trajectory(n_frames=n_frames, revs=revs)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512, pix_noise=0.5,
                                       desc_noise=0.05)
    slam = MonocularSLAM(world.cam_params, map_capacity=(48, 512, 4096), desc_dim=64,
                         config=TrackerConfig(local_map_only=True), device="cpu")
    feed(slam, frames)
    st = slam.state
    n1 = slam.n_kf
    ramp = np.clip((np.arange(st.K) - 1) / 3.0, 0.0, 1.0)
    off = torch.from_numpy((ramp[:, None] * MERGE_DELTA[None, :]).astype(np.float32))
    centers = -torch.einsum("kji,kj->ki", st.kf_R_cw, st.kf_t_cw)
    t_new = -torch.einsum("kij,kj->ki", st.kf_R_cw, centers + off)
    anchor = st.lm_anchor_kf.long().clamp(0, st.K - 1)
    st = st.replace(
        kf_t_cw=torch.where(torch.arange(st.K)[:, None] < n1, t_new, st.kf_t_cw),
        lm_pos=torch.where(st.lm_active[:, None], st.lm_pos + off[anchor], st.lm_pos))
    return world, frames, st, n1


def merge_scene():
    """tests/test_multisession.py's warped two-session scene at the moment
    of a merge: the warped stored map, session two's keyframes in map 1,
    the query keyframe, the stored keyframe closest in time to its view,
    their Sim3 (the port's solve) and the stored map's keyframe mask."""
    from rover_slam_tpu_torch.slam import loop_closing as tlc
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    from rover_slam_tpu_torch.slam.tracking import TrackerConfig
    from rover_slam_tpu_torch.utils import config
    world, frames, st_old, n1 = warped_session()
    slam = MonocularSLAM(world.cam_params, map_capacity=(48, 512, 4096), desc_dim=64,
                         config=TrackerConfig(local_map_only=True), device="cpu")
    config.resume_atlas(slam, st_old)
    feed(slam, frames[:8], dt=500.0)
    st = slam.state
    q = slam.n_kf - 1
    assert int(st.kf_map_id[q]) == 1 and q >= n1 + 2
    # The stored keyframe closest in time to the query's view.
    t_q = float(st.kf_time[q]) - 500.0
    c = int(np.argmin(np.abs(st.kf_time.numpy()[:n1] - t_q)))
    ok, _, s, R, t, n_proj = tlc._sim3_pair_guided(st, q, c, torch.from_numpy(CAM),
                                                   torch.Generator().manual_seed(0), 0, False)
    assert bool(ok) and int(n_proj) >= 40
    in_old = st.kf_active & (st.kf_map_id == 0)
    return st, q, c, (s, R, t), in_old


IMU_CALIB = dict(Rbc=np.eye(3, dtype=np.float32), tbc=np.zeros(3, np.float32),
                 sigma_g=np.float32(1.7e-4 * np.sqrt(200.0)),
                 sigma_a=np.float32(2e-3 * np.sqrt(200.0)),
                 walk_g=np.float32(1.9e-5 / np.sqrt(200.0)),
                 walk_a=np.float32(3e-3 / np.sqrt(200.0)))   # tests/test_e2e_inertial.py


class InitDraws:
    """The JAX package's two-view RANSAC draws shared with the port: while
    jax_side() is active each call of the JAX reconstruct records its
    samples (its first key split and weighted choice); while torch_side() is
    active the port's reconstruct replays them in order, in place of its
    torch.Generator draws (the two generators give different numbers)."""

    def __init__(self):
        self.draws = []

    @contextlib.contextmanager
    def jax_side(self):
        import jax
        import jax.numpy as jnp
        from rover_slam_tpu.geometry import two_view as jtv
        orig = jtv.reconstruct

        def recording(x1, x2, mask, key, *a, n_hyp=400, **k):
            _, k1 = jax.random.split(key)
            p = jnp.asarray(mask, jnp.float32) / jnp.maximum(jnp.sum(mask), 1)
            self.draws.append(np.asarray(jax.random.choice(k1, x1.shape[0], shape=(n_hyp, 8),
                                                           replace=True, p=p)))
            return orig(x1, x2, mask, key, *a, n_hyp=n_hyp, **k)

        jtv.reconstruct = recording
        try:
            yield self
        finally:
            jtv.reconstruct = orig

    @contextlib.contextmanager
    def torch_side(self):
        from rover_slam_tpu_torch.geometry import two_view as ttv
        orig = ttv.reconstruct

        def replaying(x1, x2, mask, generator=None, **k):
            return orig(x1, x2, mask, samples=torch.from_numpy(self.draws.pop(0)), **k)

        ttv.reconstruct = replaying
        try:
            yield self
        finally:
            ttv.reconstruct = orig


def _kf_snapshot(slam, times, gt_pos):
    """The system's keyframes as they stand now: their camera centres and
    the metric ATE (Horn without scale) of those centres against the truth
    at the keyframes' frames."""
    from rover_slam_tpu.utils import trajectory
    k = int(slam.n_kf)
    R, t = _np(slam.state.kf_R_cw)[:k], _np(slam.state.kf_t_cw)[:k]
    centres = -np.einsum("kji,kj->ki", R, t)
    frame = np.abs(_np(slam.state.kf_time)[:k, None] - times[None, :]).argmin(1)
    return dict(centres=centres, frame=frame,
                ate_metric=trajectory.ate_rmse(centres, gt_pos[frame], with_scale=False)[0])


def inertial_pair(n_frames, pipeline=0, tinit_s=1.5, n_scored=None, seed=0, snap_frame=None):
    """Both MonocularInertialSLAMs over tests/test_e2e_inertial.py's ring
    world at its per-frame motion (orbit_with_imu at dt 0.1, 1.2 revolutions
    per 120 frames), cut to n_frames; 64-D descriptors, 512 keypoints,
    tables 64 / 512 / 4096. Each side's inertial-only solves are recorded.
    The port's two-view init runs on the JAX package's RANSAC draws (each
    call of the JAX reconstruct records its samples, the port's replays
    them in order): with its own torch.Generator draws the port picks
    another RANSAC winner, and the init map's poses part by ~1 % before the
    IMU init, which moved the first inertial-only scale by 1.15 %.
    Returns ({"jax": run, "torch": run}, ground truth); a run holds the
    slam, the per-frame states, the frame at which imu_ready turned true,
    the solves' (scale, Rwg, bg, ba) and, for the JAX run, the solves'
    inputs (problem, kwargs), the camera centres of the first n_scored
    frames (None: all) and the metric and scale-aligned ATE (Horn without
    and with scale) over those of them after the init, and with snap_frame
    the _kf_snapshot taken after that frame. seed is the ring world's."""
    import jax.numpy as jnp
    from rover_slam_tpu.imu import preintegration as jpre
    from rover_slam_tpu.optim import inertial_init as jii
    from rover_slam_tpu.slam.inertial_system import MonocularInertialSLAM as JaxVI
    from rover_slam_tpu.utils import trajectory
    from rover_slam_tpu_torch.optim import inertial_init as tii
    from rover_slam_tpu_torch.slam.inertial_system import MonocularInertialSLAM as TorchVI
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.ring_world(n_landmarks=6000, desc_dim=64, seed=seed)
    R_gt, t_gt, times, _, imu = synthetic.orbit_with_imu(n_frames=n_frames,
                                                         revs=1.2 * n_frames / 120, dt=0.1)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512, pix_noise=0.5,
                                       desc_noise=0.05)
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(n_frames)])
    calib = jpre.ImuCalib(**{k: jnp.asarray(v) for k, v in IMU_CALIB.items()})
    draws = InitDraws()
    out = {}
    for name, cls, mod, side, kw in (
            ("jax", JaxVI, jii, draws.jax_side, {}),
            ("torch", TorchVI, tii, draws.torch_side, dict(device="cpu"))):
        solves, inputs = [], []
        orig = mod.inertial_only_optimization

        def recording(*a, orig=orig, solves=solves, inputs=inputs, **k):
            res = orig(*a, **k)
            solves.append(tuple(_np(x) for x in (res.scale, res.Rwg, res.bg, res.ba)))
            inputs.append((a, k, res))
            return res

        mod.inertial_only_optimization = recording
        try:
            with side():
                slam = cls(world.cam_params, calib, tinit_s=tinit_s,
                           map_capacity=(64, 512, 4096), desc_dim=64, pipeline=pipeline, **kw)
                states, ready, snap = [], None, None
                for i, f in enumerate(frames):
                    if i > 0:
                        for a, g, t in zip(*imu[i - 1]):
                            slam.feed_imu(a, g, t)
                    states.append(slam.track_frame(f.kpts, f.rays, f.desc, f.valid,
                                                   f.time)["state"])
                    if slam.imu_ready and ready is None:
                        ready = i
                    if i == snap_frame:
                        snap = _kf_snapshot(slam, times, gt_pos)
                slam.flush()
        finally:
            mod.inertial_only_optimization = orig
        est_t, est_R, est_tcw = slam.get_trajectory()
        pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])[:n_scored]
        after = [(i, j) for i, j in trajectory.associate_by_time(est_t, times)
                 if ready is not None and ready < j < len(pos)]
        e = np.stack([pos[i] for i, _ in after])
        g = np.stack([gt_pos[j] for _, j in after])
        out[name] = dict(slam=slam, states=states, ready=ready, solves=solves,
                         snap=snap,
                         inputs=inputs if name == "jax" else None, pos=pos,
                         ate_metric=trajectory.ate_rmse(e, g, with_scale=False)[0],
                         ate_scaled=trajectory.ate_rmse(e, g, with_scale=True)[0])
    return out, gt_pos


def check_inertial_pair(runs, pos_atol):
    """What both inertial scenes hold: states equal frame by frame; each of
    the JAX package's inertial-only solves repeated by the port on its exact
    inputs (scale rtol 1e-4, ba 1e-4, velocities 1e-4 and cost rtol 1e-4,
    as tests/test_torch_inertial_init.py holds the solve; with 5 keyframes
    the joint refine ends along a flat direction 7e-6 apart in bg, at costs
    1e-5 apart, and 1.0e-5 apart in Rwg at 8 torch threads, so bg 2e-5 and
    Rwg 3e-5); the IMU initialized at the same frame by the same solves on
    each side's own map (scale rtol 2e-3, Rwg atol 1e-3, bg atol 5e-4, ba atol 5e-3: the
    keyframe poses entering the init differ by the rounding of the frames
    before it; on the JAX draws the first scale differed by at most 0.044 %
    over both scenes at 1 and 8 torch / XLA threads; ba lies along a weakly
    observed direction),
    final biases alike (bg 5e-4, ba 1e-2), trajectories within pos_atol (m)
    and metric ATEs within 1 cm of each other (for runs with a snapshot,
    inertial_pair's snap_frame: the keyframes as they stood at that frame
    instead of the final trajectory), the port's final metric ATE under
    0.15 m (the e2e test's bound), and the VI refinement and VI-BA ran after
    the init."""
    from rover_slam_tpu_torch.optim import inertial_init as tii
    j, t = runs["jax"], runs["torch"]
    assert t["states"] == j["states"]
    assert t["ready"] == j["ready"] is not None
    for (a, k, rj) in j["inputs"]:
        rt = tii.inertial_only_optimization(torch_problem(tii.InertialInitProblem, a[0]),
                                            *a[1:], **k)
        np.testing.assert_allclose(float(rt.scale), float(rj.scale), rtol=1e-4)
        np.testing.assert_allclose(rt.Rwg.numpy(), np.asarray(rj.Rwg), rtol=0, atol=3e-5)
        np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), rtol=0, atol=2e-5)
        np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-4)
        np.testing.assert_allclose(rt.v_wb.numpy(), np.asarray(rj.v_wb), rtol=0, atol=1e-4)
    assert len(t["solves"]) == len(j["solves"]) >= 1
    for st, sj in zip(t["solves"], j["solves"]):
        np.testing.assert_allclose(st[0], sj[0], rtol=2e-3)
        np.testing.assert_allclose(st[1], sj[1], atol=1e-3)
        np.testing.assert_allclose(st[2], sj[2], atol=5e-4)
        np.testing.assert_allclose(st[3], sj[3], atol=5e-3)
    ts, js = t["slam"], j["slam"]
    np.testing.assert_allclose(_np(ts.bg), _np(js.bg), atol=5e-4)
    np.testing.assert_allclose(_np(ts.ba), _np(js.ba), atol=1e-2)
    if j["snap"] is None:
        assert t["pos"].shape == j["pos"].shape
        np.testing.assert_allclose(t["pos"], j["pos"], atol=pos_atol)
        assert abs(t["ate_metric"] - j["ate_metric"]) < 0.01
    else:
        np.testing.assert_array_equal(t["snap"]["frame"], j["snap"]["frame"])
        np.testing.assert_allclose(t["snap"]["centres"], j["snap"]["centres"], atol=pos_atol)
        assert abs(t["snap"]["ate_metric"] - j["snap"]["ate_metric"]) < 0.01
    assert t["ate_metric"] < 0.15
    assert ts.vi_refines > 0 and ts.vi_ba_runs >= 2
    assert ts.timers.summary()["vi_pose"]["count"] == js.timers.summary()["vi_pose"]["count"]


class AppLog(list):
    """recording_app's per-frame log; .slam is the system the app built."""
    slam = None


@contextlib.contextmanager
def recording_app(app, method="track_frame"):
    """Patch an app module's build_system so that the system it builds logs
    one entry per call of `method` (track_frame, or track_stereo_frame for
    the stereo sensors): (tracking state, imu_ready, keyframes, tracked
    inliers, body position p_wb as a numpy array or None); yields the log."""
    log = AppLog()
    orig = app.build_system

    def build(*a, **k):
        slam = orig(*a, **k)
        log.slam = slam
        track = getattr(slam, method)

        def track_frame(*aa, **kk):
            info = track(*aa, **kk)
            p = getattr(slam, "p_wb", None)
            log.append((int(info["state"]), bool(getattr(slam, "imu_ready", False)),
                        int(slam.n_kf), int(info.get("n_inliers", -1)),
                        None if p is None else np.asarray(_np(p), np.float64).copy()))
            return info

        setattr(slam, method, track_frame)
        return slam

    app.build_system = build
    try:
        yield log
    finally:
        app.build_system = orig
