"""The port's batched decompositions on all-zero blocks, card against CPU.

The batched CUDA eigh once left an all-zero matrix's outputs unwritten, so a
padded slot read whatever the caching allocator handed out (ROADMAP.md C4).
Each case here feeds one decomposition site of the port a batch that mixes
real blocks with all-zero blocks, at the batch size the site sees on its
path, after filling the allocator's free blocks with NaN; the card's output
must equal the port's on the CPU for the same input. Each case is run twice:
at the decomposition call as the site writes it (its shape, its options and
the regularisation it adds), and, where the site has a function of its own,
through that function.

Every test needs an NVIDIA GPU and skips without one. This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda_zero_blocks.py
"""
import numpy as np
import pytest
import torch

from rover_slam_tpu_torch.geometry import lie, two_view
from rover_slam_tpu_torch.imu import preintegration
from rover_slam_tpu_torch.optim import sim3_solver

pytestmark = pytest.mark.cuda

# Card against CPU on the real blocks: LAPACK and cuSOLVER round differently.
ATOL = 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CPU tests hold the repaired sites)")
    return torch.device("cuda")


def nan_fill_allocator():
    """Fill the caching allocator's free blocks with NaN: one large block
    (the large pool) and many small ones (the 2 MiB segments of the small
    pool), all freed again, so that an output the card leaves unwritten
    reads NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    big = torch.full((64 << 20,), float("nan"), device="cuda")
    small = [torch.full((n,), float("nan"), device="cuda")
             for n in (16, 64, 256, 1024, 4096, 16384, 65536, 262144) for _ in range(24)]
    torch.cuda.synchronize()
    del big, small


def _blocks(rng, batch, shape, zero_every=3, spd=False, scale=1.0):
    """[batch, *shape] float32: Gaussian blocks (symmetric positive definite
    with spd), every zero_every-th block all zero."""
    a = rng.normal(size=(batch,) + shape).astype(np.float32) * scale
    if spd:
        a = a @ np.swapaxes(a, -1, -2) / shape[-1] + np.eye(shape[-1], dtype=np.float32)
    a[::zero_every] = 0.0
    return torch.from_numpy(a)


def _align_svd(out, ref):
    """The card's (U, S, Vt) with each singular pair's sign taken from the
    CPU's (a singular vector is defined up to its sign)."""
    U, S, Vt = out
    Ur, _, Vtr = ref
    k = S.shape[-1]
    sg = torch.sign(torch.sum(U[..., :, :k] * Ur[..., :, :k], dim=-2))
    sg = torch.where(sg == 0, 1.0, sg)
    U = torch.cat([U[..., :, :k] * sg[..., None, :], U[..., :, k:]], -1)
    Vt = torch.cat([Vt[..., :k, :] * sg[..., :, None], Vt[..., k:, :]], -2)
    extra = Vt.shape[-2] - k                      # full_matrices=True: the null rows
    if extra > 0:
        sn = torch.sign(torch.sum(Vt[..., k:, :] * Vtr[..., k:, :], dim=-1))
        Vt = torch.cat([Vt[..., :k, :], Vt[..., k:, :] * torch.where(sn == 0, 1.0, sn)[..., None]],
                       -2)
    return U, S, Vt


def _svd(full):
    return lambda A: torch.linalg.svd(A, full_matrices=full)


# (site, batch inputs on the CPU, the call, canonicalise the card's output
# against the CPU's or None). Batch sizes are those of the sites' paths:
# 300 Sim3 / PnP hypotheses, 400 two-view hypotheses, 8 LO refits over 1024
# matches, 512 keyframe slots, 64 IMU segments.
def _op_cases():
    rng = np.random.default_rng(0)
    eye = lambda n: torch.eye(n)
    return [
        ("optim/sim3_solver.py:35 svd(W) [300,3,3]",
         lambda: (_blocks(rng, 300, (3, 3)),), _svd(True), _align_svd),
        ("optim/sim3_solver.py:179 solve_ex(JTJ) [7,7]",
         lambda: (torch.zeros(7, 7) + 1e-4 * eye(7), torch.zeros(7)),
         lambda A, b: torch.linalg.solve_ex(A, b)[0], None),
        ("optim/pnp.py:38 svd(A) [300,12,12]",
         lambda: (_blocks(rng, 300, (12, 12)),), _svd(False), _align_svd),
        ("optim/pnp.py:40 svd(P[:3]) [300,3,3]",
         lambda: (_blocks(rng, 300, (3, 3)),), _svd(True), _align_svd),
        ("geometry/two_view.py:59 svd(A) [400,8,9]",
         lambda: (_blocks(rng, 400, (8, 9)),), _svd(False), _align_svd),
        ("geometry/two_view.py:59 svd(A) LO refit [8,1024,9]",
         lambda: (_blocks(rng, 8, (1024, 9), zero_every=2),), _svd(False), _align_svd),
        ("geometry/two_view.py:65 svd(E) [400,3,3]",
         lambda: (_blocks(rng, 400, (3, 3)),), _svd(True), _align_svd),
        ("geometry/two_view.py:79 svd(A) [400,8,9] full",
         lambda: (_blocks(rng, 400, (8, 9)),), _svd(True), _align_svd),
        ("geometry/two_view.py:105 inv_ex(H) [400,3,3]",
         lambda: (_blocks(rng, 400, (3, 3)) + 1e-12 * eye(3),),
         lambda H: torch.linalg.inv_ex(H).inverse, None),
        ("geometry/two_view.py:118 svd(E) [3,3]",
         lambda: (torch.zeros(3, 3),), _svd(True), _align_svd),
        ("geometry/two_view.py:132 svd(H) [3,3]",
         lambda: (torch.zeros(3, 3),), _svd(True), _align_svd),
        ("geometry/lie.py:113 svd(R) [512,3,3]",
         lambda: (_blocks(rng, 512, (3, 3)),), _svd(True), _align_svd),
        ("imu/preintegration.py:207 inv_ex(C9) [64,9,9]",
         lambda: (_blocks(rng, 64, (9, 9), spd=True) + 1e-9 * eye(9),),
         lambda C: torch.linalg.inv_ex(C).inverse, None),
        ("optim/vi_ba.py:275 solve_ex(Hs) [150,150]",
         lambda: _vi_ba_system(rng), lambda A, b: torch.linalg.solve_ex(A, b)[0], None),
        ("optim/inertial_init.py:63 solve_ex(AtA) [99,99]",
         lambda: _normal_equations(rng), lambda A, b: torch.linalg.solve_ex(A, b)[0], None),
        ("optim/inertial_init.py:158 inv_ex(info6) [32,6,6]",
         lambda: (_blocks(rng, 32, (6, 6), spd=True) + 1e-8 * eye(6),),
         lambda C: torch.linalg.inv_ex(C).inverse, None),
        ("optim/inertial_init.py:160 inv_ex(C6) [32,6,6]",
         lambda: (_blocks(rng, 32, (6, 6), spd=True) + 1e-4 * eye(6),),
         lambda C: torch.linalg.inv_ex(C).inverse, None),
        ("optim/inertial_init.py:166 eigh(W6) as mended (C4) [32,6,6]",
         lambda: (_blocks(rng, 32, (6, 6), spd=True),),
         lambda M: _mended_eigh(M), None),
        ("optim/inertial_init.py:219-220 inv_ex(info9) [32,9,9]",
         lambda: (_blocks(rng, 32, (9, 9), spd=True) + 1e-6 * eye(9),),
         lambda C: torch.linalg.inv_ex(torch.linalg.inv_ex(C).inverse
                                       + 1e-4 * torch.eye(9, device=C.device)).inverse, None),
    ]


def _mended_eigh(W6):
    """_linear_vgs's square root of W6 as C4's repair writes it: a padded
    (all-zero) slot takes the identity before eigh and a zero factor after."""
    on = (W6 != 0).flatten(-2).any(-1)[:, None, None]
    eye6 = torch.eye(6, device=W6.device)
    lam, U = torch.linalg.eigh(torch.where(on, W6, eye6))
    Ws = U @ torch.diag_embed(torch.sqrt(torch.clamp(lam, min=0.0))) @ U.transpose(-1, -2)
    return torch.where(on, Ws, torch.zeros_like(Ws))


def _vi_ba_system(rng, Kw=10, D=15, pad=4):
    """vi_ba's equilibrated damped system over Kw keyframe slots of which the
    last `pad` are padding: their rows and columns zero, then the identity
    on their diagonal, Jacobi-scaled, plus 1e-7 I."""
    n = Kw * D
    J = rng.normal(size=(3 * n, n)).astype(np.float32)
    H = torch.from_numpy(J.T @ J)
    fix = (torch.arange(Kw) >= Kw - pad).repeat_interleave(D)
    Hm = torch.where(fix[:, None] | fix[None, :], 0.0, H) + torch.diag(fix.float())
    d = torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)) * (~fix).float()
    return Hm / d[:, None] / d[None, :] + 1e-7 * torch.eye(n), -(g / d)


def _normal_equations(rng, K=32, pad=8):
    """_linear_vgs's A^T A + 1e-6 I with the rows of padded slots zero."""
    nv = 3 * K + 3
    A = rng.normal(size=(6 * K, nv)).astype(np.float32)
    A[6 * (K - pad):] = 0.0
    A[:, 3 * (K - pad):3 * K] = 0.0
    A, b = torch.from_numpy(A), torch.from_numpy(rng.normal(size=6 * K).astype(np.float32))
    return A.T @ A + 1e-6 * torch.eye(nv), A.T @ b


def _function_cases():
    """The sites' own functions on inputs that make all-zero blocks where the
    paths make them: Sim3 hypotheses whose three points are padding (W = 0),
    a refit and a GN refine with no inlier, LO refits of empty inlier sets,
    zero rotations, zero IMU covariances; the real blocks beside them are
    well-posed (a scalene triangle moved by a Sim3, a two-view scene with
    parallax), so that the card and the CPU must agree on them too. A PnP or
    homography sample never makes an all-zero DLT matrix (its rows hold the
    homogeneous 1), so those sites are probed at the call only."""
    rng = np.random.default_rng(1)

    def horn():
        tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.3, 0.8, 0.0]], np.float32)
        Rp = np.stack([lie_rot(rng) for _ in range(300)])
        P = torch.from_numpy(np.einsum("hij,mj->hmi", Rp, tri).astype(np.float32))
        Rq = torch.from_numpy(np.stack([lie_rot(rng) for _ in range(300)]))
        Q = 1.3 * P @ Rq.transpose(-1, -2) + 0.2
        P[::3], Q[::3] = 0.0, 0.0                           # samples of padded pairs
        return P, Q

    def horn_empty():
        P = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
        return P, P + 0.5, torch.zeros(64)

    def refine():
        X = torch.from_numpy(np.c_[rng.normal(size=(64, 2)), rng.uniform(3, 6, 64)]
                             .astype(np.float32))
        uv = torch.from_numpy(rng.uniform(0, 600, (64, 2)).astype(np.float32))
        cam = torch.tensor([458.0, 458.0, 320.0, 240.0, 0, 0, 0, 0])
        return X, uv, torch.zeros(64, dtype=torch.bool), cam

    def eight_point():
        X = np.c_[rng.normal(size=(1024, 2)) * 2, rng.uniform(4, 8, 1024)].astype(np.float32)
        R = lie_rot(rng, 0.1)
        X2 = X @ R.T + np.array([0.3, 0.05, 0.02], np.float32)
        x1 = torch.from_numpy(X[:, :2] / X[:, 2:]).expand(8, -1, -1).contiguous()
        x2 = torch.from_numpy((X2[:, :2] / X2[:, 2:]).astype(np.float32))
        x2 = x2.expand(8, -1, -1).contiguous()
        w = torch.from_numpy((rng.uniform(size=(8, 1024)) > 0.3).astype(np.float32))
        w[::2] = 0.0                                        # empty inlier sets
        return x1, x2, w

    def rotations():
        R = torch.from_numpy(np.stack([lie_rot(rng) for _ in range(512)]))
        R[::3] = 0.0
        return (R,)

    def covariances():
        C = _blocks(rng, 64, (15, 15), spd=True) * 1e-4
        return (C,)

    return [
        ("optim/sim3_solver.py:35 horn_sim3 [300]", horn, sim3_solver.horn_sim3, None),
        ("optim/sim3_solver.py:35 horn_sim3 refit w=0", horn_empty, sim3_solver.horn_sim3,
         None),
        ("optim/sim3_solver.py:179 sim3_gn_refine no inlier", refine,
         lambda X, uv, m, cam: sim3_solver.sim3_gn_refine(
             X, uv, m, torch.ones((), device=X.device), torch.eye(3, device=X.device),
             torch.zeros(3, device=X.device), cam), None),
        ("geometry/two_view.py:59,65 _eight_point_E LO refit [8,1024]", eight_point,
         two_view._eight_point_E, _align_sign),
        ("geometry/lie.py:113 normalize_rotation [512]", rotations, lie.normalize_rotation,
         None),
        ("imu/preintegration.py:207 information_9 [64]", covariances,
         lambda C: preintegration.information_9(_preint_with_cov(C)), None),
    ]


def lie_rot(rng, scale=1.0):
    w = rng.normal(size=3).astype(np.float32) * scale
    return lie.so3_exp(torch.from_numpy(w)).numpy()


def _preint_with_cov(C):
    z3, z33 = torch.zeros(C.shape[:-2] + (3,), device=C.device), \
        torch.zeros(C.shape[:-2] + (3, 3), device=C.device)
    return preintegration.PreintState(dR=z33, dV=z3, dP=z3, C=C, JRg=z33, JVg=z33, JVa=z33,
                                      JPg=z33, JPa=z33, dt=torch.zeros(C.shape[:-2]),
                                      bg=z3, ba=z3)


def _align_sign(got, want):
    """An essential matrix is defined up to its sign (the null vector's)."""
    (g,), (w,) = got, want
    sg = torch.sign(torch.sum(g.cpu() * w, dim=(-2, -1)))
    return (g.cpu() * torch.where(sg == 0, 1.0, sg)[..., None, None],)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _compare(name, got, want, atol):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().cpu().double(), w.detach().double()
        fin_w = torch.isfinite(w)
        assert torch.equal(torch.isfinite(g), fin_w), \
            f"{name}: output {i} finite on the CPU but not on the card, or the reverse"
        scale = max(1.0, float(w[fin_w].abs().max())) if fin_w.any() else 1.0
        err = float((g[fin_w] - w[fin_w]).abs().max()) if fin_w.any() else 0.0
        assert err <= atol * scale, f"{name}: output {i} differs by {err:.3g} (scale {scale:.3g})"


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_decomposition_on_zero_blocks(dev, case):
    name, make, call, canon = case
    args = make()
    want = _as_tuple(call(*args))
    nan_fill_allocator()
    got = _as_tuple(call(*(a.to(dev) for a in args)))
    torch.cuda.synchronize()
    got = tuple(x.cpu() for x in got)
    if canon is not None:
        got = canon(got, want)
    _compare(name, got, want, ATOL)


@pytest.mark.parametrize("case", _function_cases(), ids=lambda c: c[0])
def test_site_function_on_zero_blocks(dev, case):
    name, make, fn, canon = case
    args = make()
    want = _as_tuple(fn(*args))
    nan_fill_allocator()
    got = _as_tuple(fn(*(a.to(dev) for a in args)))
    torch.cuda.synchronize()
    if canon is not None:
        got = canon(got, want)
    _compare(name, got, want, ATOL)
