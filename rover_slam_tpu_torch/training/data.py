"""Supervised pair generation from the synthetic photo world.

Counterpart of rover_slam_tpu/training/data.py: each sample is a pair of
rendered grayscale views of one random sprite world from two nearby poses,
with the exact pixels of every sprite centre in both views. The numpy RNG is
drawn in the JAX package's order and the rotations are its f32 Rodrigues to
the bit (`so3_exp_f32`), so a seed gives the same samples.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie
from ..utils import synthetic


class PairSample(NamedTuple):
    img0: np.ndarray     # [H,W] float32 in [0,1]
    img1: np.ndarray
    uv0: np.ndarray      # [M,2] float32 sprite-center pixels in view 0
    uv1: np.ndarray      # [M,2]
    vis0: np.ndarray     # [M] bool sprite visible (in-border, z in range)
    vis1: np.ndarray     # [M] bool


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (lib.sinf, lib.cosf):
        fn.argtypes = [ctypes.c_float]
        fn.restype = ctypes.c_float
    return lib


def so3_exp_f32(w) -> np.ndarray:
    """[3,3] float32 rotation exp(hat(w)) of a float64 vector w, equal to the
    bit to the JAX package's lie.so3_exp(w) with x64 off: the squares are
    taken in float64 (numpy's `w * w`) and summed in f32, the sine and
    cosine are the C library's sinf / cosf (the functions XLA's CPU backend
    calls; torch's vectorized ones differ in the last bit, which moves a
    rendered sprite edge now and then), and the Taylor branch is
    lie._sinc_coeffs'."""
    w = np.asarray(w, np.float64)
    sq = (w * w).astype(np.float32)
    theta2 = (sq[0] + sq[1]) + sq[2]
    theta = np.sqrt(np.maximum(theta2, np.float32(lie._EPS * lie._EPS)))
    if theta2 < 1e-8:
        a = np.float32(1.0) - theta2 / np.float32(6.0)
        b = np.float32(0.5) - theta2 / np.float32(24.0)
    else:
        a = np.float32(_libm().sinf(theta)) / theta
        b = (np.float32(1.0) - np.float32(_libm().cosf(theta))) / theta2
    W = lie.so3_hat(torch.from_numpy(w.astype(np.float32)))
    return (torch.eye(3) + torch.tensor(a) * W + torch.tensor(b) * (W @ W)).numpy()


def _so3(rng, max_deg):
    w = rng.normal(size=3)
    w = w / (np.linalg.norm(w) + 1e-9) * np.deg2rad(rng.uniform(0, max_deg))
    return so3_exp_f32(w)


def _project(world, R_cw, t_cw, border=8, z_near=1.0):
    h, w = world.image_hw
    fx, fy, cx, cy = np.asarray(world.cam_params[:4], np.float64)
    Xc = (R_cw @ world.points.T).T + t_cw
    z = Xc[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
    vis = ((z > z_near) & (u >= border) & (u < w - border)
           & (v >= border) & (v < h - border))
    return np.stack([u, v], 1).astype(np.float32), vis


def make_pair(rng, n_sprites=500, image_hw=(240, 320), patch=13,
              max_rot_deg=10.0, max_trans=0.8, noise=0.02) -> PairSample:
    """One random world + two nearby views with GT correspondences."""
    seed = int(rng.integers(0, 2**31 - 1))
    world = synthetic.make_photo_world(
        n_sprites=n_sprites, patch=patch, seed=seed, layout="cloud",
        image_hw=image_hw, fx=220.0 * image_hw[1] / 320.0, auto_z0=True)

    def pose():
        R = _so3(rng, max_rot_deg)
        t = rng.uniform(-max_trans, max_trans, 3) * np.array([1, 0.6, 0.6])
        return R, t.astype(np.float64)

    R0, t0 = pose()
    R1, t1 = pose()
    img0 = synthetic.render_photo_frame(world, R0, t0).astype(np.float32) / 255.0
    img1 = synthetic.render_photo_frame(world, R1, t1).astype(np.float32) / 255.0
    if noise > 0:   # photometric augmentation: noise + gain/bias jitter
        for im in (img0, img1):
            im *= rng.uniform(0.8, 1.2)
            im += rng.uniform(-0.08, 0.08)
            im += rng.normal(0, noise, im.shape).astype(np.float32)
            np.clip(im, 0.0, 1.0, out=im)
    uv0, vis0 = _project(world, R0, t0)
    uv1, vis1 = _project(world, R1, t1)
    return PairSample(img0, img1, uv0, uv1, vis0, vis1)


def detector_labels(uv: np.ndarray, vis: np.ndarray, image_hw,
                    cell: int = 8) -> np.ndarray:
    """[Hc,Wc] int32 65-way labels: within-cell pixel index of a GT keypoint,
    or 64 (dustbin) for empty cells (SuperPoint detector head semantics)."""
    h, w = image_hw
    hc, wc = h // cell, w // cell
    lab = np.full((hc, wc), 64, np.int32)
    for (u, v) in uv[vis]:
        ui, vi = int(u), int(v)
        ci, cj = vi // cell, ui // cell
        if 0 <= ci < hc and 0 <= cj < wc:
            lab[ci, cj] = (vi % cell) * cell + (ui % cell)
    return lab


def render_batch(rng, batch: int, image_hw=(240, 320), n_corr: int = 192,
                 **kw) -> dict:
    """Render `batch` pairs -> stacked arrays for the SuperPoint train step:
    img0/img1 [B,H,W,1], lab0/lab1 [B,Hc,Wc], uv0/uv1 [B,C,2] (co-visible GT
    correspondences, zero-padded), corr_valid [B,C]."""
    img0, img1, lab0, lab1, uv0s, uv1s, cvs = [], [], [], [], [], [], []
    for _ in range(batch):
        s = make_pair(rng, image_hw=image_hw, **kw)
        img0.append(s.img0[..., None])
        img1.append(s.img1[..., None])
        lab0.append(detector_labels(s.uv0, s.vis0, image_hw))
        lab1.append(detector_labels(s.uv1, s.vis1, image_hw))
        both = np.nonzero(s.vis0 & s.vis1)[0][:n_corr]
        u0 = np.zeros((n_corr, 2), np.float32)
        u1 = np.zeros((n_corr, 2), np.float32)
        cv = np.zeros((n_corr,), bool)
        u0[:len(both)] = s.uv0[both]
        u1[:len(both)] = s.uv1[both]
        cv[:len(both)] = True
        uv0s.append(u0)
        uv1s.append(u1)
        cvs.append(cv)
    return {"img0": np.stack(img0), "img1": np.stack(img1),
            "lab0": np.stack(lab0), "lab1": np.stack(lab1),
            "uv0": np.stack(uv0s), "uv1": np.stack(uv1s),
            "corr_valid": np.stack(cvs)}
