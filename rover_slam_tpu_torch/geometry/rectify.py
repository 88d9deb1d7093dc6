"""Stereo rectification: raw (distorted, non-coplanar) pairs to row-aligned
rectified pairs.

Counterpart of rover_slam_tpu/geometry/rectify.py (the reference's
cv::stereoRectify + initUndistortRectifyMap path). The maps are built once
per rig in numpy; the per-frame work runs on the caller's device:
- `remap(img, map_xy)`: image-space rectification before extraction, a
  bilinear gather (the JAX package jits it; it is no Pallas kernel);
- `rectify_points(kpts, ...)`: feature-space rectification of raw keypoints.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie


class StereoRectification(NamedTuple):
    """Per-eye remap grids (image path), per-eye rectifying rotations
    (feature path), the common rectified intrinsics and baseline*fx."""
    map1: np.ndarray     # [H, W, 2] raw source px per rectified px, left
    map2: np.ndarray     # right
    K_new: np.ndarray    # (fx, fy, cx, cy) of both rectified views
    bf_px: float         # fx_new * baseline (the reference's mbf)
    R1: np.ndarray       # rectifying rotation, left (x_rect = R1 x_raw)
    R2: np.ndarray       # right


def radtan_distort(xy, dist):
    """Radial-tangential distortion of normalized coordinates xy [..., 2]
    (numpy or torch); dist = (k1, k2, p1, p2)."""
    k1, k2, p1, p2 = [dist[i] for i in range(4)]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    if isinstance(x, np.ndarray):
        return np.stack([xd, yd], axis=-1)
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(xy, dist, iters: int = 8):
    """Invert radtan distortion by fixed-point iteration (undistortPoints)."""
    out = xy
    for _ in range(iters):
        out = xy - (radtan_distort(out, dist) - out)
    return out


def stereo_rectify_maps(K1, D1, K2, D2, R_21, t_21, image_hw) -> StereoRectification:
    """Bouguet rectification (cv::stereoRectify, the alpha=0 crop skipped):
    map_i [H, W, 2] gives the raw source pixel of every rectified pixel.
    K_i = (fx, fy, cx, cy); D_i = (k1, k2, p1, p2); x_2 = R_21 x_1 + t_21.
    The half rotation goes through f32 so3 maps, as in the JAX package."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R_21 = np.asarray(R_21, np.float64)
    t_21 = np.asarray(t_21, np.float64)
    H, W = image_hw
    om = lie.so3_log(torch.tensor(R_21, dtype=torch.float32)).numpy().astype(np.float64)
    r_half = lie.so3_exp(torch.tensor(-0.5 * om, dtype=torch.float32)).numpy()
    r_half = r_half.astype(np.float64)
    t = r_half @ t_21
    # Baseline axis -> rectified x axis (horizontal rig).
    e1 = t / np.linalg.norm(t)
    e2 = np.array([-t[1], t[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = e2 / n2 if n2 > 1e-12 else np.array([0.0, 1.0, 0.0])
    ww = np.stack([e1, e2, np.cross(e1, e2)])
    if ww[0, 0] < 0:    # right-to-left rigs: keep the axes near the originals
        ww[0] *= -1.0
        ww[1] *= -1.0
    R1 = ww @ r_half.T
    R2 = ww @ r_half
    fn = 0.5 * (K1[0] + K2[0])
    K_new = np.array([fn, fn, W / 2.0, H / 2.0])

    def build_map(K, D, R_rect):
        u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        rays = np.stack([(u - K_new[2]) / K_new[0], (v - K_new[3]) / K_new[1],
                         np.ones_like(u)], axis=-1)
        raw = rays @ R_rect
        raw = raw[..., :2] / np.maximum(raw[..., 2:3], 1e-9)
        rawd = radtan_distort(raw, np.asarray(D, np.float64))
        return np.stack([rawd[..., 0] * K[0] + K[2],
                         rawd[..., 1] * K[1] + K[3]], axis=-1).astype(np.float32)

    return StereoRectification(build_map(K1, D1, R1), build_map(K2, D2, R2),
                               K_new.astype(np.float32), float(fn * np.linalg.norm(t_21)),
                               R1.astype(np.float32), R2.astype(np.float32))


def remap(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear remap with a zero border (cv::remap): img [H, W] or
    [H, W, C], map_xy [H', W', 2] raw (x, y) source per target pixel."""
    H, W = img.shape[:2]
    x, y = map_xy[..., 0], map_xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        if img.dim() == 3:
            inb = inb[..., None]
        return torch.where(inb, val, 0.0)

    w = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    if img.dim() == 3:
        w = [a[..., None] for a in w]
    return (w[0] * tap(y0i, x0i) + w[1] * tap(y0i, x0i + 1)
            + w[2] * tap(y0i + 1, x0i) + w[3] * tap(y0i + 1, x0i + 1))


def rectify_points(kpts, K_raw, D_raw, R_rect, K_new):
    """RAW pixel keypoints [N, 2] into the rectified view: undistort, rotate
    by R_rect, project with K_new."""
    xn = torch.stack([(kpts[..., 0] - K_raw[2]) / K_raw[0],
                      (kpts[..., 1] - K_raw[3]) / K_raw[1]], dim=-1)
    out = radtan_undistort(xn, D_raw)
    rot = torch.cat([out, torch.ones_like(out[..., :1])], dim=-1) @ R_rect.T
    xy = rot[..., :2] / torch.clamp(rot[..., 2:3], min=1e-9)
    return torch.stack([xy[..., 0] * K_new[0] + K_new[2],
                        xy[..., 1] * K_new[1] + K_new[3]], dim=-1)
