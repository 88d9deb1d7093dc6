"""Entry points of the port (counterpart of the repo's __graft_entry__.py).

entry()              -> (fn, example_args): the single-device front-end
                        step (SuperPoint extraction of a frame pair, then
                        LightGlue matching of the pair) at 240x320, 256
                        keypoints, 3 LightGlue layers, Flax-style random
                        initialization (models/weights.py::flax_init_).
dryrun_multichip(n)  -> one sharded mapping step on an n-shard mesh:
                        (a) SuperPoint on a frame batch split over the
                        shards, (b) edge-sharded BA, (c) landmark-sharded
                        BA, (d) the live loop's global BA through
                        maintenance.global_ba(mesh=) on a 4-keyframe map.
Both run on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .geometry import cameras
from .map import maintenance
from .map import map_state as ms
from .models.lightglue import LightGlue, extract_matches, normalize_keypoints
from .models.superpoint import SuperPoint, extract_keypoints
from .models.weights import flax_init_
from .optim import ba
from .parallel import sharded_ba

ENTRY_HW = (240, 320)
ENTRY_KPTS = 256
ENTRY_LAYERS = 3


def frontend_step(sp: SuperPoint, lg: LightGlue, images: torch.Tensor):
    """images [2, H, W, 1] -> (matches0 [1, K] int32, mscores0 [1, K],
    keypoints [2, K, 2]): extract both frames, match the pair."""
    H, W = images.shape[1:3]
    prob, desc_c = sp(images)
    out = extract_keypoints(prob, desc_c, max_keypoints=ENTRY_KPTS)
    k = normalize_keypoints(out["keypoints"], (H, W))
    d, v = out["descriptors"], out["valid"]
    la, _, _ = lg(k[0:1], d[0:1], v[0:1], k[1:2], d[1:2], v[1:2])
    m = extract_matches(la, v[0:1], v[1:2])
    return m["matches0"], m["mscores0"], out["keypoints"]


def entry(device=None):
    """(fn, example_args): fn(sp, lg, images) is frontend_step; the example
    arguments are the two bf16 networks, initialized as Flax initializes
    them from a torch.Generator seeded with 0, and a zero frame pair."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    sp = flax_init_(SuperPoint(dtype=torch.bfloat16), gen).to(dev).eval()
    lg = flax_init_(LightGlue(num_layers=ENTRY_LAYERS, dtype=torch.bfloat16), gen).to(dev).eval()
    images = torch.zeros((2,) + ENTRY_HW + (1,), device=dev)
    return torch.no_grad()(frontend_step), (sp, lg, images)


def _tiny_problem(dev):
    """__graft_entry__.py's 4-keyframe, 32-landmark problem: keyframes on a
    line looking at a slab of points, every landmark seen by every
    keyframe, landmarks 1 cm off."""
    rng = np.random.default_rng(0)
    Kw, Lw = 4, 32
    cam = cameras.make_pinhole(100.0, 100.0, 48.0, 32.0, device=dev)
    Xw = np.stack([rng.uniform(-2, 2, Lw), rng.uniform(-2, 2, Lw),
                   rng.uniform(4, 8, Lw)], 1).astype(np.float32)
    R_t = np.tile(np.eye(3, dtype=np.float32), (Kw, 1, 1))
    t_t = np.zeros((Kw, 3), np.float32)
    t_t[:, 0] = 0.1 * np.arange(Kw)
    Xc = np.einsum("kij,lj->kli", R_t, Xw) + t_t[:, None]
    uv = cameras.project(cameras.PINHOLE, cam, torch.from_numpy(Xc.reshape(-1, 3)).to(dev))
    E = Kw * Lw
    prob = ba.BAProblem(
        R_cw=torch.from_numpy(R_t).to(dev), t_cw=torch.from_numpy(t_t).to(dev),
        pose_opt_mask=torch.arange(Kw, device=dev) > 0,
        lm_pos=torch.from_numpy(Xw + 0.01).to(dev),
        lm_opt_mask=torch.ones(Lw, dtype=torch.bool, device=dev), cam_params=cam,
        e_kf=torch.arange(Kw, device=dev, dtype=torch.int32).repeat_interleave(Lw),
        e_lm=torch.arange(Lw, device=dev, dtype=torch.int32).repeat(Kw), e_uv=uv,
        e_valid=torch.ones(E, dtype=torch.bool, device=dev),
        e_info=torch.ones(E, device=dev))
    return prob, uv.reshape(Kw, Lw, 2)


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """One sharded mapping step on make_mesh(n_shards, device) at tiny
    shapes. Raises if an output is not finite; returns the step's outputs."""
    mesh = sharded_ba.make_mesh(n_shards, device=device)
    dev = mesh.device

    # (a) data-parallel extraction: one frame per shard, vectorised over the
    # shard axis, per-shard sums psum'd.
    H, W = 64, 96
    sp = flax_init_(SuperPoint(dtype=torch.float32), torch.Generator().manual_seed(0))
    with torch.no_grad():
        prob, desc = sp.to(dev)(torch.ones((mesh.n_local, H, W, 1), device=dev))
    sums = (mesh.psum(prob.reshape(mesh.n_local, -1).sum(dim=1)),
            mesh.psum(desc.reshape(mesh.n_local, -1).sum(dim=1)))

    # (b) edge-sharded and (c) landmark-sharded BA.
    bprob, uv = _tiny_problem(dev)
    out_e = sharded_ba.solve_ba_sharded(bprob, mesh, iters=2, cg_iters=4)
    out_l = sharded_ba.solve_ba_sharded_lm(bprob, mesh, iters=2, cg_iters=4)

    # (d) the live loop's entry: global BA on a 4-keyframe map with the mesh.
    Kw, Lw = uv.shape[:2]
    st = ms.empty_map(K=Kw, N=Lw, L=Lw, D=8, device=dev)
    st, _ = ms.add_landmarks(st, bprob.lm_pos, torch.zeros((Lw, 8), device=dev),
                             torch.zeros((Lw, 3), device=dev),
                             torch.zeros(Lw, dtype=torch.int32, device=dev),
                             torch.ones(Lw, dtype=torch.bool, device=dev))
    for k in range(Kw):
        st, _ = ms.add_keyframe(st, bprob.R_cw[k], bprob.t_cw[k], uv[k],
                                torch.ones((Lw, 3), device=dev),
                                torch.zeros((Lw, 8), device=dev),
                                torch.ones(Lw, dtype=torch.bool, device=dev),
                                torch.arange(Lw, dtype=torch.int32, device=dev), float(k))
    st2 = maintenance.global_ba(st, bprob.cam_params, iters=2, mesh=mesh)

    res = {"extract_sums": sums, "edges": out_e, "landmarks": out_l,
           "gba_t_cw": st2.kf_t_cw}
    finite = [torch.isfinite(torch.stack(sums)).all(), torch.isfinite(out_e[3]).all(),
              torch.isfinite(out_l[3]).all(), torch.isfinite(st2.kf_t_cw).all()]
    if not all(bool(f) for f in finite):
        raise FloatingPointError(f"dryrun_multichip({n_shards}): outputs not finite {finite}")
    return res
