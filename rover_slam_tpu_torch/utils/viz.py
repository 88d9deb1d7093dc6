"""Headless map/trajectory visualization.

Counterpart of rover_slam_tpu/utils/viz.py, the stand-in for the
reference's Pangolin viewer (src/Viewer.cc, FrameDrawer.cc, MapDrawer.cc):
the same content rendered to image files / arrays with matplotlib's Agg
backend, imported at first use. It takes the port's MapState on either
device and works on host copies.
"""
from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_map(state, out_path: str, trajectory=None, gt=None, title=""):
    """Top-down (x-z) map points + keyframe positions + optional trajectory
    (reference MapDrawer::DrawMapPoints/DrawKeyFrames)."""
    plt = _plt()
    lm = _np(state.lm_pos)
    lm_ok = _np(state.lm_active).astype(bool)
    kfa = _np(state.kf_active).astype(bool)
    R = _np(state.kf_R_cw)
    t = _np(state.kf_t_cw)
    centers = np.stack([-R[i].T @ t[i] for i in range(len(t))])

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(lm[lm_ok, 0], lm[lm_ok, 2], s=1, c="#999999", label="landmarks")
    ax.scatter(centers[kfa, 0], centers[kfa, 2], s=12, c="#1f77b4", label="keyframes")
    if trajectory is not None:
        tr = _np(trajectory)
        ax.plot(tr[:, 0], tr[:, 2], "-", c="#2ca02c", lw=1, label="trajectory")
    if gt is not None:
        g = _np(gt)
        ax.plot(g[:, 0], g[:, 2], "--", c="#d62728", lw=1, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best")
    ax.set_title(title)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_frame_overlay(image, kpts, landmark_idx, out_path: str | None = None):
    """Tracked-point overlay (reference FrameDrawer::DrawFrame: green = tracked
    map point, blue = unmatched keypoint). Returns an RGB array."""
    plt = _plt()
    image = _np(image)
    h, w = image.shape[:2]
    fig, ax = plt.subplots(figsize=(w / 100, h / 100))
    ax.imshow(image, cmap="gray", vmin=0, vmax=1)
    k = _np(kpts)
    tracked = _np(landmark_idx) >= 0
    ax.scatter(k[~tracked, 0], k[~tracked, 1], s=4, c="#1f77b4", marker="o")
    ax.scatter(k[tracked, 0], k[tracked, 1], s=6, c="#2ca02c", marker="o")
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.axis("off")
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if out_path:
        fig.savefig(out_path, dpi=100, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return buf
