"""Relocalization in the port against the JAX package, on a map the port
built: PnP RANSAC, the global landmark-table relocalization and the
relocalization from learned keyframe matches. The two runtimes draw
different random numbers, so the port is handed the JAX package's own draws.
Tolerances: PnP inliers identical, R and t within 1e-4; relocalization ok
equal, R and t within 1e-3, landmark ids equal on >= 99 % of keypoints (bf16
descriptor near-ties), n_inliers within 2."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rover_slam_tpu.geometry import lie as jlie
from rover_slam_tpu.ops import association as jas
from rover_slam_tpu.optim import pnp as jpnp
from rover_slam_tpu.slam import tracking as jT
from rover_slam_tpu_torch.optim import pnp as tpnp
from rover_slam_tpu_torch.slam import tracking as tT
from rover_slam_tpu_torch.slam.system import MonocularSLAM

from torch_parity import CAM, _np, synthetic_frames, to_jax_state

N_HYP = 300


def _draws(key, ok):
    """jax.random.choice as pnp_ransac draws its [300, 6] samples."""
    p = jnp.asarray(ok, jnp.float32) / max(int(np.sum(ok)), 1)
    return np.asarray(jax.random.choice(key, len(ok), shape=(N_HYP, 6), replace=True, p=p))


def test_pnp_ransac_with_injected_draws():
    rng = np.random.default_rng(0)
    M = 400
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(3, 15, M)],
                 1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t = np.asarray([0.3, -0.2, 0.5], np.float32)
    Xc = X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:] * CAM[:2] + CAM[2:4]).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:150] += rng.uniform(-80, 80, (150, 2)).astype(np.float32)      # outliers
    valid = rng.uniform(size=M) > 0.1
    key = jax.random.PRNGKey(3)
    rj = jpnp.pnp_ransac(*(jnp.asarray(a) for a in (X, uv, valid, CAM)), key)
    rt = tpnp.pnp_ransac(*(torch.from_numpy(a) for a in (X, uv, valid, CAM)),
                         samples=torch.from_numpy(_draws(key, valid)))
    assert bool(rt.success) == bool(rj.success) is True
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_allclose(rt.R_cw.numpy(), np.asarray(rj.R_cw), atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.t_cw.numpy(), np.asarray(rj.t_cw), atol=1e-4, rtol=0)
    # The generator path draws its own samples and finds the same pose.
    rg = tpnp.pnp_ransac(*(torch.from_numpy(a) for a in (X, uv, valid, CAM)),
                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(rg.t_cw.numpy(), t, atol=0.05)


@pytest.fixture(scope="module")
def scene():
    """A map the port built over the first 20 frames; the lost frame is
    frame 10's observation, as in tests/test_e2e_mono.py's kidnap."""
    world, frames, _ = synthetic_frames(30)
    slam = MonocularSLAM(world.cam_params, map_capacity=(64, 512, 8192), desc_dim=64,
                         device="cpu")
    for f in frames[:20]:
        slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)
    assert slam.n_kf >= 3
    return slam, frames[10], to_jax_state(slam.state)


def _assert_reloc_matches(out_t, out_j):
    R_t, t_t, lm_t, ok_t, n_t = out_t
    R_j, t_j, lm_j, ok_j, n_j = out_j
    assert bool(ok_t) == bool(ok_j)
    assert abs(int(n_t) - int(n_j)) <= 2, (int(n_t), int(n_j))
    np.testing.assert_allclose(_np(R_t), np.asarray(R_j), atol=1e-3, rtol=0)
    np.testing.assert_allclose(_np(t_t), np.asarray(t_j), atol=1e-3, rtol=0)
    assert (_np(lm_t) == np.asarray(lm_j)).mean() >= 0.99
    return bool(ok_t), int(n_t)


def _frame_args(f):
    return f.kpts, f.desc, f.valid


def test_relocalize_kernel_global(scene):
    slam, f, st_j = scene
    key = jax.random.PRNGKey(11)
    active = np.asarray(st_j.lm_active & (st_j.lm_map_id == st_j.active_map_id))
    m_j, _ = jas.mutual_nn_match(jnp.asarray(f.desc), jnp.asarray(f.valid),
                                 st_j.lm_desc.astype(jnp.float32), jnp.asarray(active),
                                 ratio=0.8)
    samples = _draws(key, np.asarray(m_j) >= 0)
    out_j = jT._relocalize_kernel(st_j, *(jnp.asarray(a) for a in _frame_args(f)),
                                  jnp.asarray(CAM), key, 0)
    out_t = tT._relocalize_kernel(slam.state, *(torch.from_numpy(a) for a in _frame_args(f)),
                                  torch.from_numpy(CAM), samples=torch.from_numpy(samples))
    ok, n = _assert_reloc_matches(out_t, out_j)
    assert ok and n >= 30


def test_relocalize_kernel_fails_on_garbage(scene):
    slam, f, st_j = scene
    rng = np.random.default_rng(99)
    desc = rng.normal(size=f.desc.shape).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    args = (f.kpts, desc, f.valid)
    key = jax.random.PRNGKey(12)
    active = np.asarray(st_j.lm_active)
    m_j, _ = jas.mutual_nn_match(jnp.asarray(desc), jnp.asarray(f.valid),
                                 st_j.lm_desc.astype(jnp.float32), jnp.asarray(active),
                                 ratio=0.8)
    out_j = jT._relocalize_kernel(st_j, *(jnp.asarray(a) for a in args), jnp.asarray(CAM),
                                  key, 0)
    out_t = tT._relocalize_kernel(slam.state, *(torch.from_numpy(a) for a in args),
                                  torch.from_numpy(CAM),
                                  samples=torch.from_numpy(_draws(key, np.asarray(m_j) >= 0)))
    assert bool(out_t[3]) == bool(out_j[3])
    assert int(out_t[4]) < 30 and int(out_j[4]) < 30


def test_reloc_from_kf_matches(scene):
    """B=3 candidates (the three newest keyframes, as the system picks them
    without loop closing), matched to the frame by mutual NN in the JAX
    package; one split key per candidate."""
    slam, f, st_j = scene
    n_kf = slam.n_kf
    cand = np.asarray([n_kf - 1, n_kf - 2, n_kf - 3], np.int32)
    ext = np.stack([np.asarray(jas.mutual_nn_match(
        st_j.kf_desc[c].astype(jnp.float32), st_j.kf_kpt_valid[c], jnp.asarray(f.desc),
        jnp.asarray(f.valid), ratio=0.8)[0]) for c in cand])
    key = jax.random.PRNGKey(13)
    keys = jax.random.split(key, len(cand))
    N = f.kpts.shape[0]
    samples = []
    for b, c in enumerate(cand):
        kf_lidx = np.asarray(st_j.kf_landmark_idx[c])
        has = (ext[b] >= 0) & (kf_lidx >= 0) & np.asarray(st_j.kf_kpt_valid[c])
        inv = np.asarray(jas.invert_matches(jnp.asarray(np.where(has, ext[b], -1)), N))
        lm = np.where(inv >= 0, kf_lidx[np.clip(inv, 0, N - 1)], -1)
        ok = (lm >= 0) & f.valid & np.asarray(st_j.lm_active)[np.clip(lm, 0, None)]
        samples.append(_draws(keys[b], ok))
    out_j = jT._reloc_from_kf_matches(st_j, jnp.asarray(cand), jnp.asarray(ext),
                                      *(jnp.asarray(a) for a in _frame_args(f)),
                                      jnp.asarray(CAM), key, 0)
    out_t = tT._reloc_from_kf_matches(slam.state, torch.from_numpy(cand),
                                      torch.from_numpy(ext),
                                      *(torch.from_numpy(a) for a in _frame_args(f)),
                                      torch.from_numpy(CAM),
                                      samples=torch.from_numpy(np.stack(samples)))
    ok, n = _assert_reloc_matches(out_t, out_j)
    assert ok and n >= 30
