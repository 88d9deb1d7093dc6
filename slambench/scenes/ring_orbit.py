"""Ring-orbit scenes: a photo world of textured sprites around an orbit,
rendered frames and ground-truth poses.

A frozen copy of the port's generators (rover_slam_tpu_torch/utils/
synthetic.py: make_photo_world, render_photo_frame, orbit_trajectory,
orbit_with_imu), so that a later change to the program cannot move the
yardstick. The rotations go through the same f32 torch arithmetic on the CPU
as the port's lie.so3_exp, so the same parameters give the same bits
(slambench/tests/test_slambench_scenes.py holds this).

make_route(traffic, config) builds the whole route of a traffic file's
world and orbit with a configuration's camera; it does not depend on the
seed, so its rendered frames are cached once per checkout. for_seed(route,
traffic, seed) is a run's scene: route["frames"] frames of that route,
starting at a frame the seed draws among the first "start_offsets". Every
seed drives the same world along the same orbit with the same per-frame
motion, from another place on it: the same work, in another order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


# --- f32 rotations, as rover_slam_tpu_torch/geometry/lie.py computes them ---

def _so3_hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def so3_exp(w) -> np.ndarray:
    """Rodrigues in f32 torch on the CPU: w [3] -> R [3, 3] (numpy)."""
    w = torch.as_tensor(np.asarray(w, np.float32))
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-8 * 1e-8))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    Wm = _so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype)
    return (eye + A[..., None, None] * Wm + B[..., None, None] * (Wm @ Wm)).numpy()


# --- the photo world -------------------------------------------------------

class PhotoWorld(NamedTuple):
    points: np.ndarray        # [M,3] sprite centres (world)
    patches: np.ndarray       # [M,P,P] per-sprite texture in [0,1]
    cam_params: np.ndarray    # [8] pinhole fx, fy, cx, cy, 0...
    image_hw: tuple
    z0: Optional[np.ndarray] = None   # [M] per-sprite reference depth


def _random_patches(rng, m: int, p: int) -> np.ndarray:
    coarse = rng.uniform(0.0, 1.0, (m, (p + 1) // 2, (p + 1) // 2))
    pat = np.repeat(np.repeat(coarse, 2, axis=1), 2, axis=2)[:, :p, :p]
    pat = 0.15 + 0.85 * (pat > 0.5) * rng.uniform(0.55, 1.0, (m, p, p))
    pat[:, 0, :] = pat[:, -1, :] = pat[:, :, 0] = pat[:, :, -1] = 1.0
    return pat.astype(np.float32)


def make_photo_world(n_sprites=600, patch=11, seed=0, image_hw=(240, 320), fx=220.0,
                     ring_radius=12.0, ring_height=3.0, ring_spread=4.0,
                     ring_orbit_radius=None) -> PhotoWorld:
    """The port's make_photo_world(layout="ring"): a thick cylindrical shell
    of sprites around the origin."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_sprites)
    r = ring_radius + rng.uniform(-ring_spread, ring_spread, n_sprites)
    y = rng.uniform(-ring_height, ring_height, n_sprites)
    pts = np.stack([r * np.sin(th), y, r * np.cos(th)], 1)
    z0 = None
    if ring_orbit_radius is not None:
        z0 = np.maximum(r - ring_orbit_radius, 1.2).astype(np.float32)
    h, w = image_hw
    cam = np.asarray([fx, fx, w / 2.0, h / 2.0, 0, 0, 0, 0], np.float32)
    return PhotoWorld(pts.astype(np.float32), _random_patches(rng, n_sprites, patch),
                      cam, tuple(image_hw), z0=z0)


def render_photo_frame(world: PhotoWorld, R_cw, t_cw, z_ref: float = 8.0,
                       background: float = 0.30) -> np.ndarray:
    """One grayscale uint8 image: each visible sprite's patch pasted at its
    projection, scaled by depth, far to near."""
    h, w = world.image_hw
    t_cw = np.asarray(t_cw, np.float64)
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


# --- routes ------------------------------------------------------------------

def orbit_trajectory(n_frames=80, orbit_radius=5.0, seed=1, noise=0.001, dt=0.1, revs=1.05):
    """The camera orbits the origin looking outward. (R_cw, t_cw, times)."""
    rng = np.random.default_rng(seed)
    Rs, ts, times = [], [], []
    for i in range(n_frames):
        th = 2 * np.pi * revs * i / n_frames
        p_wc = np.array([orbit_radius * np.sin(th), 0.0, orbit_radius * np.cos(th)],
                        np.float32)
        R_wc = so3_exp([0.0, th, 0.0])
        p_wc += rng.normal(0, noise, 3).astype(np.float32)
        R_cw = R_wc.T
        Rs.append(R_cw); ts.append(-R_cw @ p_wc); times.append(i * dt)
    return np.stack(Rs), np.stack(ts), np.asarray(times, np.float32)


def orbit_with_imu(n_frames=100, orbit_radius=5.0, revs=1.25, dt=0.1, hz=200,
                   bg=(0.002, -0.001, 0.003), ba=(-0.02, 0.03, 0.01),
                   noise_g=1.7e-4, noise_a=2e-3, seed=2, g_w=(0.0, -9.81, 0.0)):
    """Analytic circular orbit with a radial wobble and a vertical bob (the
    jerk that makes monocular scale observable), camera == body, and IMU
    samples between the frames: specific force R^T (a - g) + ba and rate
    w + bg, each with white noise of density noise_* drawn in sample order.
    Returns (R_cw [F,3,3], t_cw [F,3], times [F], v_wb [F,3],
    imu: per frame gap (acc [n,3], gyro [n,3], t [n]))."""
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
        return so3_exp([0.0, th, 0.0]), p, v, a, w_b

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
                t_s = t_f + (j + 1) / hz * (dt * hz / n_per)
                Rj, _, _, aj, wj = body_state(t_s)
                f_b = Rj.T @ (aj - g) + ba + rng.normal(0, noise_a * np.sqrt(hz), 3)
                w_m = wj + bg + rng.normal(0, noise_g * np.sqrt(hz), 3)
                accs.append(f_b.astype(np.float32))
                gyros.append(w_m.astype(np.float32))
                tt.append(t_s)
            imu.append((np.stack(accs), np.stack(gyros), np.asarray(tt)))
    return np.stack(Rs), np.stack(ts), np.asarray(times, np.float32), np.stack(vs), imu


# --- the scene a cell runs -----------------------------------------------------

class Scene(NamedTuple):
    cam: np.ndarray           # [8] pinhole parameters
    image_hw: tuple
    world: PhotoWorld
    R_cw: np.ndarray          # [F,3,3] ground truth
    t_cw: np.ndarray          # [F,3]
    times: np.ndarray         # [F] seconds
    first: int = 0            # the route's index of frame 0

    def render(self, i: int) -> np.ndarray:
        return render_photo_frame(self.world, self.R_cw[i], self.t_cw[i])


def camera_params(config: dict) -> np.ndarray:
    return np.asarray([config["fx"], config["fy"], config["cx"], config["cy"], 0, 0, 0, 0],
                      np.float32)


def route_length(traffic: dict) -> int:
    return int(traffic["route"]["frames"]) + int(traffic["start_offsets"])


def make_route(traffic: dict, config: dict) -> Scene:
    """The whole route: traffic["world"] sets the world, traffic["route"]
    the orbit and its per-frame motion, route_length(traffic) its frames.
    Route kind "wobble" (the default) is orbit_with_imu's analytic orbit
    with its radial wobble and vertical bob (its IMU samples unused, without
    noise); kind "circle" is orbit_trajectory's circle (bench.py's; 1 mm of
    jitter from its own seed 1)."""
    hw = (int(config["height"]), int(config["width"]))
    cam = camera_params(config)
    wp = traffic["world"]
    world = make_photo_world(n_sprites=wp["n_sprites"], patch=wp["patch"], seed=wp["seed"],
                             image_hw=hw, ring_radius=wp["ring_radius"],
                             ring_height=wp["ring_height"], ring_spread=wp["ring_spread"],
                             ring_orbit_radius=wp["orbit_radius"])
    world = world._replace(cam_params=cam)
    route = traffic["route"]
    n = route_length(traffic)
    revs = float(route["revolutions_per_frame"]) * n
    dt = 1.0 / float(config["camera_hz"])
    if route.get("kind", "wobble") == "circle":
        R, t, times = orbit_trajectory(n_frames=n, orbit_radius=route["orbit_radius"],
                                       revs=revs, dt=dt)
    else:
        R, t, times, _, _ = orbit_with_imu(n_frames=n, orbit_radius=route["orbit_radius"],
                                           revs=revs, dt=dt, bg=(0.0, 0.0, 0.0),
                                           ba=(0.0, 0.0, 0.0), noise_g=0.0, noise_a=0.0)
    return Scene(cam, hw, world, R, t, times)


def first_frame(traffic: dict, seed: int) -> int:
    """The route frame a seed's run starts at, drawn among the first
    traffic["start_offsets"]."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    return int(rng.integers(int(traffic["start_offsets"])))


def for_seed(route: Scene, traffic: dict, seed: int) -> Scene:
    """A run's scene: traffic["route"]["frames"] frames of the route from
    first_frame(traffic, seed)."""
    k = first_frame(traffic, seed)
    n = int(traffic["route"]["frames"])
    return route._replace(R_cw=route.R_cw[k:k + n], t_cw=route.t_cw[k:k + n],
                          times=route.times[k:k + n], first=k)


def frame_key(traffic: dict, config: dict) -> dict:
    """What the route's rendered frames depend on (not the seed): the render
    cache's key."""
    return {"world": traffic["world"], "route": traffic["route"],
            "frames": route_length(traffic),
            "camera": {k: config[k] for k in ("width", "height", "fx", "fy", "cx", "cy")},
            "camera_hz": config["camera_hz"], "generator": "ring_orbit", "version": 3}
