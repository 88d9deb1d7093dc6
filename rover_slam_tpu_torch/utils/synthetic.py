"""Synthetic SLAM worlds with ground truth (counterpart of
rover_slam_tpu/utils/synthetic.py).

Worlds, trajectories and frames come from numpy RNGs seeded exactly as in the
JAX package, so the same seeds give the same worlds; the few rotations and
projections go through this package's f32 geometry on the CPU. Outputs are
numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie, cameras


def _so3_exp(w) -> np.ndarray:
    return lie.so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def _project(kind, params, X) -> np.ndarray:
    return cameras.project(kind, torch.as_tensor(np.asarray(params, np.float32)),
                           torch.as_tensor(np.asarray(X, np.float32))).numpy()


def _unproject(kind, params, uv) -> np.ndarray:
    return cameras.unproject(kind, torch.as_tensor(np.asarray(params, np.float32)),
                             torch.as_tensor(np.asarray(uv, np.float32))).numpy()


def _pinhole(fx, fy, cx, cy) -> np.ndarray:
    return np.asarray([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0], np.float32)


class SyntheticWorld(NamedTuple):
    landmarks: np.ndarray     # [L,3] world points
    desc: np.ndarray          # [L,D] unit descriptors (the landmark identity)
    cam_params: np.ndarray
    cam_kind: int
    image_hw: tuple


class SyntheticFrame(NamedTuple):
    kpts: np.ndarray          # [N,2] pixels (noisy)
    rays: np.ndarray          # [N,3] unprojected bearings of noisy kpts
    desc: np.ndarray          # [N,D] noisy unit descriptors
    valid: np.ndarray         # [N] bool
    lm_id: np.ndarray         # [N] true landmark id (diagnostics only)
    R_cw: np.ndarray          # ground truth pose
    t_cw: np.ndarray
    time: float


def make_world(n_landmarks=4000, desc_dim=64, seed=0,
               extent=((-8, 8), (-6, 6), (0, 25)),
               image_hw=(480, 640)) -> SyntheticWorld:
    rng = np.random.default_rng(seed)
    L = n_landmarks
    pts = np.stack([rng.uniform(*extent[0], L), rng.uniform(*extent[1], L),
                    rng.uniform(*extent[2], L)], 1).astype(np.float32)
    d = rng.normal(size=(L, desc_dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam = _pinhole(458.654, 457.296, 367.215, 248.375)
    return SyntheticWorld(pts, d, cam, cameras.PINHOLE, image_hw)


def ring_world(n_landmarks=6000, desc_dim=64, seed=0, radius=12.0, height=4.0,
               image_hw=(480, 640)) -> SyntheticWorld:
    """Landmarks on a cylinder wall around the orbit: every viewpoint of
    orbit_trajectory sees texture (the loop-closure scene)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_landmarks)
    r = radius + rng.uniform(-1.0, 1.0, n_landmarks)
    y = rng.uniform(-height, height, n_landmarks)
    pts = np.stack([r * np.sin(th), y, r * np.cos(th)], 1).astype(np.float32)
    d = rng.normal(size=(n_landmarks, desc_dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam = _pinhole(458.654, 457.296, 367.215, 248.375)
    return SyntheticWorld(pts, d, cam, cameras.PINHOLE, image_hw)


def forward_trajectory(n_frames=60, dt=0.1, speed=0.5, yaw_rate=0.05, seed=1,
                       lateral=0.6):
    """Forward + lateral motion with gentle yaw and jitter.
    Returns (R_cw [F,3,3], t_cw [F,3], times [F])."""
    rng = np.random.default_rng(seed)
    Rs, ts, times = [], [], []
    R_wc = np.eye(3, dtype=np.float32)
    p_wc = np.zeros(3, dtype=np.float32)
    for i in range(n_frames):
        w = np.array([0.0, yaw_rate, 0.0], np.float32) * dt
        w += rng.normal(0, 0.002, 3).astype(np.float32)
        R_wc = R_wc @ _so3_exp(w)
        v = R_wc @ np.array([lateral * speed, 0.0, speed], np.float32)
        p_wc = p_wc + v * dt + rng.normal(0, 0.002, 3).astype(np.float32)
        R_cw = R_wc.T
        t_cw = -R_cw @ p_wc
        Rs.append(R_cw.copy()); ts.append(t_cw.copy()); times.append(i * dt)
    return np.stack(Rs), np.stack(ts), np.asarray(times, np.float32)


def orbit_trajectory(n_frames=80, orbit_radius=5.0, seed=1, noise=0.001,
                     dt=0.1, revs=1.05):
    """Camera orbits the origin looking outward. Returns (R_cw, t_cw, times)."""
    rng = np.random.default_rng(seed)
    Rs, ts, times = [], [], []
    for i in range(n_frames):
        th = 2 * np.pi * revs * i / n_frames
        p_wc = np.array([orbit_radius * np.sin(th), 0.0,
                         orbit_radius * np.cos(th)], np.float32)
        R_wc = _so3_exp([0.0, th, 0.0])
        p_wc += rng.normal(0, noise, 3).astype(np.float32)
        R_cw = R_wc.T
        Rs.append(R_cw); ts.append(-R_cw @ p_wc); times.append(i * dt)
    return np.stack(Rs), np.stack(ts), np.asarray(times, np.float32)


def _imu_samples(body_state, n_frames, dt, hz, g_w, bg, ba, noise_g, noise_a, seed,
                 sample_time):
    """Ground truth at the frames and IMU samples between them from an
    analytic body_state(t) -> (R_wb, p, v, a, w_b): specific force
    R^T (a - g) + ba and rate w_b + bg, each with white noise, drawn in
    sample order from one generator. Camera == body."""
    rng = np.random.default_rng(seed)
    g = np.asarray(g_w, np.float32)
    bg = np.asarray(bg, np.float32)
    ba = np.asarray(ba, np.float32)
    Rs, ts, vs, times, imu = [], [], [], [], []
    n_per = int(round(dt * hz))
    for i in range(n_frames):
        t_f = i * dt
        R_wb, p, v, _, _ = body_state(t_f)
        R_cw = R_wb.T
        Rs.append(R_cw); ts.append(-R_cw @ p); vs.append(v); times.append(t_f)
        if i + 1 < n_frames:
            accs, gyros, tt = [], [], []
            for j in range(n_per):
                t_s = sample_time(t_f, j, n_per)
                Rj, _, _, aj, wj = body_state(t_s)
                f_b = Rj.T @ (aj - g) + ba + rng.normal(0, noise_a * np.sqrt(hz), 3)
                w_m = wj + bg + rng.normal(0, noise_g * np.sqrt(hz), 3)
                accs.append(f_b.astype(np.float32))
                gyros.append(w_m.astype(np.float32))
                tt.append(t_s)
            imu.append((np.stack(accs), np.stack(gyros), np.asarray(tt)))
    return (np.stack(Rs), np.stack(ts), np.asarray(times, np.float32), np.stack(vs), imu)


def orbit_with_imu(n_frames=100, orbit_radius=5.0, revs=1.25, dt=0.1, hz=200,
                   bg=(0.002, -0.001, 0.003), ba=(-0.02, 0.03, 0.01),
                   noise_g=1.7e-4, noise_a=2e-3, seed=2, g_w=(0.0, -9.81, 0.0)):
    """Analytic circular orbit with IMU samples (gravity perpendicular to the
    orbit plane, -y world), camera == body. A radial wobble and a vertical
    bob give the jerk that makes monocular scale observable.

    Returns (R_cw [F,3,3], t_cw [F,3], times [F], v_wb [F,3],
             imu_per_frame: list of (acc [n,3], gyro [n,3], t [n]))."""
    omega = 2 * np.pi * revs / (n_frames * dt)
    r = orbit_radius
    w_r, A_r = 2.7, 0.25
    w_y, A_y = 3.3, 0.20
    w_b = np.array([0.0, omega, 0.0], np.float32)

    def body_state(t):
        th = omega * t
        rr = r + A_r * np.sin(w_r * t)
        dr = A_r * w_r * np.cos(w_r * t)
        ddr = -A_r * w_r * w_r * np.sin(w_r * t)
        s_, c_ = np.sin(th), np.cos(th)
        e_rad = np.array([s_, 0.0, c_])
        e_tan = np.array([c_, 0.0, -s_])
        y = A_y * np.sin(w_y * t)
        dy = A_y * w_y * np.cos(w_y * t)
        ddy = -A_y * w_y * w_y * np.sin(w_y * t)
        p = (rr * e_rad + np.array([0.0, y, 0.0])).astype(np.float32)
        v = (dr * e_rad + rr * omega * e_tan + np.array([0.0, dy, 0.0])).astype(np.float32)
        a = ((ddr - rr * omega * omega) * e_rad + 2 * dr * omega * e_tan
             + np.array([0.0, ddy, 0.0])).astype(np.float32)
        return _so3_exp([0.0, th, 0.0]), p, v, a, w_b

    return _imu_samples(body_state, n_frames, dt, hz, g_w, bg, ba, noise_g, noise_a, seed,
                        lambda t_f, j, n_per: t_f + (j + 1) / hz * (dt * hz / n_per))


def wavy_forward_with_imu(n_frames=40, dt=0.1, hz=200, v_fwd=0.9, A_x=0.45, w_x=2.2,
                          A_y=0.30, w_y=3.1, yaw_amp=0.06, yaw_w=1.7,
                          bg=(0.002, -0.001, 0.003), ba=(-0.02, 0.03, 0.01),
                          noise_g=1.7e-4, noise_a=2e-3, seed=2, g_w=(0.0, -9.81, 0.0)):
    """Analytic forward trajectory with lateral and vertical sway and a
    gentle yaw, plus IMU samples (camera == body). Returns (R_cw, t_cw,
    times, v_wb, imu) as orbit_with_imu."""
    def body_state(t):
        p = np.array([A_x * np.sin(w_x * t), A_y * np.sin(w_y * t), v_fwd * t], np.float32)
        v = np.array([A_x * w_x * np.cos(w_x * t), A_y * w_y * np.cos(w_y * t), v_fwd],
                     np.float32)
        a = np.array([-A_x * w_x ** 2 * np.sin(w_x * t), -A_y * w_y ** 2 * np.sin(w_y * t),
                      0.0], np.float32)
        yaw = yaw_amp * np.sin(yaw_w * t)
        w_b = np.array([0.0, yaw_amp * yaw_w * np.cos(yaw_w * t), 0.0], np.float32)
        return _so3_exp([0.0, yaw, 0.0]), p, v, a, w_b

    return _imu_samples(body_state, n_frames, dt, hz, g_w, bg, ba, noise_g, noise_a, seed,
                        lambda t_f, j, n_per: t_f + (j + 1) / hz)


def render_frame(world: SyntheticWorld, R_cw, t_cw, time, n_kpts=512,
                 pix_noise=0.4, desc_noise=0.08, dropout=0.05, seed=0
                 ) -> SyntheticFrame:
    """Oracle extraction: visible landmarks -> noisy keypoints/descriptors."""
    rng = np.random.default_rng((seed * 1000003 + int(time * 1e3)) % (2 ** 31))
    Xc = (R_cw @ world.landmarks.T).T + t_cw
    z = Xc[:, 2]
    uv = _project(world.cam_kind, world.cam_params, Xc)
    h, w = world.image_hw
    vis = (z > 0.3) & (z < 40.0) & (uv[:, 0] >= 8) & (uv[:, 0] < w - 8) \
        & (uv[:, 1] >= 8) & (uv[:, 1] < h - 8)
    vis &= rng.uniform(size=len(z)) > dropout
    ids = np.where(vis)[0]
    if len(ids) > n_kpts:
        ids = rng.choice(ids, n_kpts, replace=False)
    N = n_kpts
    kpts = np.zeros((N, 2), np.float32)
    desc = np.zeros((N, world.desc.shape[1]), np.float32)
    valid = np.zeros(N, bool)
    lm_id = np.full(N, -1, np.int64)
    n = len(ids)
    kpts[:n] = uv[ids] + rng.normal(0, pix_noise, (n, 2))
    d = world.desc[ids] + rng.normal(0, desc_noise, (n, world.desc.shape[1]))
    desc[:n] = d / np.linalg.norm(d, axis=1, keepdims=True)
    valid[:n] = True
    lm_id[:n] = ids
    rays = _unproject(world.cam_kind, world.cam_params, kpts)
    return SyntheticFrame(kpts, rays, desc, valid, lm_id,
                          np.asarray(R_cw, np.float32),
                          np.asarray(t_cw, np.float32), float(time))


def render_sequence(world, R_cw, t_cw, times, **kw):
    return [render_frame(world, R_cw[i], t_cw[i], times[i], seed=i, **kw)
            for i in range(len(times))]


# ---------------------------------------------------------------------------
# Photometric world: real images of textured sprites, so the SuperPoint
# network (not an oracle) produces keypoints and descriptors.
# ---------------------------------------------------------------------------

class PhotoWorld(NamedTuple):
    points: np.ndarray        # [M,3] sprite centers (world)
    patches: np.ndarray       # [M,P,P] per-sprite texture in [0,1]
    cam_params: np.ndarray
    cam_kind: int
    image_hw: tuple
    z0: np.ndarray = None     # [M] per-sprite reference depth (None = z_ref)


def _random_patches(rng, m: int, p: int) -> np.ndarray:
    coarse = rng.uniform(0.0, 1.0, (m, (p + 1) // 2, (p + 1) // 2))
    pat = np.repeat(np.repeat(coarse, 2, axis=1), 2, axis=2)[:, :p, :p]
    pat = 0.15 + 0.85 * (pat > 0.5) * rng.uniform(0.55, 1.0, (m, p, p))
    pat[:, 0, :] = pat[:, -1, :] = pat[:, :, 0] = pat[:, :, -1] = 1.0
    return pat.astype(np.float32)


def make_photo_world(n_sprites=600, patch=11, seed=0, layout="cloud",
                     image_hw=(240, 320), fx=220.0,
                     extent=((-6, 6), (-4, 4), (2, 18)),
                     ring_radius=12.0, ring_height=3.0,
                     ring_spread=4.0, ring_orbit_radius=None,
                     auto_z0=False) -> PhotoWorld:
    """layout="cloud": sprites ahead of the origin; layout="ring": a thick
    cylindrical shell around the origin (orbit trajectories)."""
    rng = np.random.default_rng(seed)
    z0 = None
    if layout == "ring":
        th = rng.uniform(0, 2 * np.pi, n_sprites)
        r = ring_radius + rng.uniform(-ring_spread, ring_spread, n_sprites)
        y = rng.uniform(-ring_height, ring_height, n_sprites)
        pts = np.stack([r * np.sin(th), y, r * np.cos(th)], 1)
        if ring_orbit_radius is not None:
            z0 = np.maximum(r - ring_orbit_radius, 1.2).astype(np.float32)
    else:
        pts = np.stack([rng.uniform(*extent[0], n_sprites),
                        rng.uniform(*extent[1], n_sprites),
                        rng.uniform(*extent[2], n_sprites)], 1)
        if auto_z0:
            z0 = np.maximum(pts[:, 2] * 0.6, 1.5).astype(np.float32)
    h, w = image_hw
    cam = _pinhole(fx, fx, w / 2.0, h / 2.0)
    return PhotoWorld(pts.astype(np.float32),
                      _random_patches(rng, n_sprites, patch),
                      cam, cameras.PINHOLE, image_hw, z0=z0)


def render_photo_frame(world: PhotoWorld, R_cw, t_cw, z_ref: float = 8.0,
                       background: float = 0.30, t_cw_offset=None) -> np.ndarray:
    """Render one grayscale uint8 image: each visible sprite's patch pasted at
    its projection, scaled by depth, far to near. t_cw_offset shifts the
    camera in its own frame (the right eye of render_photo_stereo)."""
    h, w = world.image_hw
    t_cw = np.asarray(t_cw, np.float64)
    if t_cw_offset is not None:
        t_cw = t_cw + np.asarray(t_cw_offset, np.float64)
    Xc = (np.asarray(R_cw, np.float64) @ world.points.T).T + t_cw
    z = Xc[:, 2]
    fx, fy, cx, cy = np.asarray(world.cam_params[:4], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
    yy = np.linspace(0, 0.08, h, dtype=np.float32)[:, None]
    img = np.full((h, w), background, np.float32) + yy
    p0 = world.patches.shape[1]
    vis = np.where((z > 0.5) & (np.abs(u) < 2 * w) & (np.abs(v) < 2 * h))[0]
    for i in vis[np.argsort(-z[vis])]:
        zr = float(world.z0[i]) if world.z0 is not None else z_ref
        s = int(round(p0 * zr / z[i]))
        s = max(5, min(s, 4 * p0)) | 1
        sy = (np.arange(s) * (p0 / s)).astype(np.int32)
        pat = world.patches[i][sy][:, sy]
        cy_i, cx_i = int(round(v[i])), int(round(u[i]))
        half = s // 2
        y0, y1 = cy_i - half, cy_i + half + 1
        x0, x1 = cx_i - half, cx_i + half + 1
        py0, px0 = max(0, -y0), max(0, -x0)
        y0, x0 = max(0, y0), max(0, x0)
        y1, x1 = min(h, y1), min(w, x1)
        if y1 <= y0 or x1 <= x0:
            continue
        img[y0:y1, x0:x1] = pat[py0:py0 + (y1 - y0), px0:px0 + (x1 - x0)]
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_euroc_sequence(root, world: PhotoWorld, R_cw, t_cw, times,
                         baseline: float = 0.0, imu=None,
                         t0_ns: int = 1403636579763555584, **render_kw):
    """Render a photometric sequence into an EuRoC mav0/ layout: cam0/data/
    <ns>.pgm and cam0/data.csv (with baseline > 0 also cam1/, the right eye
    of render_photo_stereo's rectified pair, one CSV per eye), imu0/data.csv
    (imu: per-frame-gap (acc [n,3], gyro [n,3], t [n]) tuples as
    orbit_with_imu gives them), and gt.txt, the camera centres in TUM
    format. The same files as the JAX package's writer. Returns (root,
    gt_path)."""
    import os
    root = str(root)
    cams = ["cam0"] + (["cam1"] if baseline > 0 else [])
    csvs = {}
    for cam in cams:
        os.makedirs(os.path.join(root, cam, "data"), exist_ok=True)
        csvs[cam] = open(os.path.join(root, cam, "data.csv"), "w")
        csvs[cam].write("#timestamp [ns],filename\n")
    h, w = world.image_hw
    try:
        for i in range(len(times)):
            ts = t0_ns + int(round(float(times[i] - times[0]) * 1e9))
            if baseline > 0:
                imgs = render_photo_stereo(world, R_cw[i], t_cw[i], baseline, **render_kw)
            else:
                imgs = [render_photo_frame(world, R_cw[i], t_cw[i], **render_kw)]
            for cam, img in zip(cams, imgs):
                csvs[cam].write(f"{ts},{ts}.pgm\n")
                with open(os.path.join(root, cam, "data", f"{ts}.pgm"), "wb") as g:
                    g.write(b"P5\n%d %d\n255\n" % (w, h) + img.tobytes())
    finally:
        for f in csvs.values():
            f.close()
    if imu is not None:
        os.makedirs(os.path.join(root, "imu0"), exist_ok=True)
        with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                    "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
            for accs, gyros, tt in imu:
                for j in range(len(tt)):
                    ts = t0_ns + int(round(float(tt[j] - times[0]) * 1e9))
                    gx, gy, gz = gyros[j]
                    ax, ay, az = accs[j]
                    f.write(f"{ts},{gx},{gy},{gz},{ax},{ay},{az}\n")
    gt_path = os.path.join(root, "gt.txt")
    with open(gt_path, "w") as f:
        for i in range(len(times)):
            p = -np.asarray(R_cw[i]).T @ np.asarray(t_cw[i])
            t_abs = t0_ns * 1e-9 + float(times[i] - times[0])
            f.write(f"{t_abs:.6f} {p[0]} {p[1]} {p[2]} 0 0 0 1\n")
    return root, gt_path


def render_photo_stereo(world: PhotoWorld, R_cw, t_cw, baseline: float, **kw):
    """Rectified stereo pair: the right camera sits +baseline along the left
    camera's x axis (t_cw_r = t_cw - [b, 0, 0]; disparity fx*b/z)."""
    left = render_photo_frame(world, R_cw, t_cw, **kw)
    right = render_photo_frame(world, R_cw, t_cw, t_cw_offset=[-baseline, 0.0, 0.0], **kw)
    return left, right
