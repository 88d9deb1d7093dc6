"""Pose-optimization problems for the port's tests of optim/pose_opt.py,
made with numpy from a seed (no JAX, so the card's tests can use them).

A true pose looks at M landmarks spread over the camera's field of view;
the observations carry 0.3 px of noise, 10 % are outliers moved 15-60 px
(chi2 far above every gate, inliers far below, so no edge sits near a gate)
and 10 % are invalid. The start pose is the true one moved by ~0.02 rad
and ~5 cm. Stereo problems add inverse depths on 60 % of the edges and
0 or -1 (no stereo row) on the rest.
"""
import numpy as np
import torch

from rover_slam_tpu_torch.geometry import cameras, lie

PINHOLE_CAM = (458.654, 457.296, 376.0, 240.0, 0.0, 0.0, 0.0, 0.0)     # EuRoC cam0
KB8_CAM = (190.978, 190.973, 254.932, 256.897, 0.00340, 0.000713, -0.00203,
           0.000304)                                                  # TUM-VI cam0
BF = 0.11 * 458.654


def _rot(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    return lie.so3_exp(torch.from_numpy((axis * angle).astype(np.float32)))


def problem(M: int, cam_kind: int, stereo: bool, seed: int = 0, device="cpu") -> dict:
    """Keyword arguments of pose_optimization (but rounds, iterations and
    check_cost) for one problem, on `device`."""
    rng = np.random.default_rng(seed)
    kb8 = cam_kind == cameras.KANNALA_BRANDT8
    cam = torch.tensor(KB8_CAM if kb8 else PINHOLE_CAM, dtype=torch.float32)
    # Directions: up to 70 degrees off the axis for the fisheye, inside the
    # 752x480 image for the pinhole.
    if kb8:
        theta = np.arccos(rng.uniform(np.cos(np.radians(70.0)), 1.0, M))
        phi = rng.uniform(0.0, 2 * np.pi, M)
        d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                      np.cos(theta)], -1)
    else:
        u = rng.uniform(20.0, 732.0, M)
        v = rng.uniform(20.0, 460.0, M)
        d = np.stack([(u - 376.0) / 458.654, (v - 240.0) / 457.296, np.ones(M)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(1.5, 12.0, M)
    Xc = torch.from_numpy((d * depth[:, None]).astype(np.float32))
    R_true = _rot(rng, 0.3)
    t_true = torch.from_numpy(rng.normal(scale=0.5, size=3).astype(np.float32))
    Xw = lie.se3_apply(*lie.se3_inverse(R_true, t_true), Xc)
    uv = cameras.project(cam_kind, cam, Xc)
    uv = uv + torch.from_numpy(rng.normal(scale=0.3, size=(M, 2)).astype(np.float32))
    out = rng.random(M) < 0.1
    shift = rng.uniform(15.0, 60.0, (M, 1)) * np.sign(rng.normal(size=(M, 2)))
    uv[torch.from_numpy(out)] += torch.from_numpy(shift[out].astype(np.float32))
    valid = torch.from_numpy(rng.random(M) > 0.1)
    R0 = _rot(rng, 0.02) @ R_true
    t0 = t_true + torch.from_numpy(rng.normal(scale=0.03, size=3).astype(np.float32))
    kw = dict(R_cw=R0, t_cw=t0, Xw=Xw, uv=uv, valid=valid, cam_params=cam,
              cam_kind=cam_kind)
    if stereo:
        zc = Xc[:, 2].numpy()
        invd = (1.0 / zc) * (1.0 + rng.normal(scale=0.002, size=M))
        has = rng.random(M) < 0.6
        invd = np.where(has, invd, np.where(rng.random(M) < 0.5, 0.0, -1.0))
        kw.update(invd=torch.from_numpy(invd.astype(np.float32)),
                  bf=torch.tensor(BF, dtype=torch.float32))
    return {k: (v.to(device).contiguous() if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()}


def gate(kw: dict, chi2_th: float) -> torch.Tensor:
    """Each edge's chi2 gate: 7.815 on stereo edges (invd > 0), else chi2_th."""
    if kw.get("invd") is None:
        return torch.full_like(kw["Xw"][:, 0], chi2_th)
    return torch.where(kw["invd"] > 0, 7.815, chi2_th)
