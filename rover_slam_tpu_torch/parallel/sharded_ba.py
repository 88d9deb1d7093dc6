"""Distributed bundle adjustment: edges, and optionally landmarks, sharded
over a mesh of shards.

Counterpart of rover_slam_tpu/parallel/sharded_ba.py. JAX's `Mesh` plus
`shard_map` becomes `Mesh` below: a process holds `n_local` shards on one
device, and a shard function runs once per process, vectorised over a
leading shard axis (edge rows [s*Es, (s+1)*Es) belong to local shard s).
`Mesh.psum` is shard_map's psum: a sum over the local shards, then an
all_reduce over the processes of the mesh's torch.distributed group.

Edge-sharded (`solve_ba_sharded`): pose and landmark variables are
replicated; every segment sum is per shard (`ops/scatterless.py`, sorted,
in entry order) followed by one psum, so each matvec costs one collective.
Landmark-sharded (`solve_ba_sharded_lm`): landmarks are split into
contiguous blocks with their edges (`partition_by_landmark`), so every
landmark-side sum is shard-local; only the pose vector and the CG inner
products cross shards. The pose-side sums are segment sums over `e_kf`: the
sharded edges are not keyframe-major, unlike optim/ba.py's global problem.

LM and CG scalars stay on the device (no host read per step); the host
reads partition_by_landmark's padded count and the segment plans' chunk
counts, which set shapes, once a solve. With one process the psums are
fixed-order sums and a solve repeats to the bit. The solvers carry the
2-dim mono rows only, as in the JAX package.
"""
from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from .. import resolve_device
from ..geometry import cameras, lie
from ..ops.scatterless import chunked_plan, seg_sum_chunked
from ..optim import ba as ba_mod
from ..optim import robust
from ..optim.blockinv import inv3, inv6

_EDGE_FIELDS = ("e_kf", "e_lm", "e_uv", "e_valid", "e_info")
# Segment sums run chunk by chunk (ops/scatterless.py::seg_sum_chunked): on
# a global problem partition_by_landmark pads every shard with ~E copies of
# edge 0, which all land in one pose and one landmark segment of the shard,
# and the card sums a segment serially (~120 ms a CG step at map scale,
# measured on the H100). Segments of at most SEG_CHUNK entries sum exactly
# as in seg_sum; the padded rows add zeros.
SEG_CHUNK = 1024


class Mesh:
    """A 1-D mesh: `n_local` shards in this process, all on `device`, in each
    process of `group` (a torch.distributed process group; None for one
    process). `size` is the number of shards over all processes and local
    shard s is global shard `rank_offset + s`."""

    def __init__(self, n_local: int, device=None, group=None):
        if n_local < 1:
            raise ValueError(f"a mesh needs at least one local shard, got {n_local}")
        self.n_local = int(n_local)
        self.device = resolve_device(device)
        self.group = group
        world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        self.size = self.n_local * world
        self.rank_offset = rank * self.n_local

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """[n_local, ...] per-shard values -> [...] their sum over every
        shard of the mesh."""
        s = x.sum(dim=0)
        if self.group is not None:
            dist.all_reduce(s, group=self.group)
        return s

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's block of a sharded array, concatenated in rank
        order along dim 0 (the whole array on every process)."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_shards: int, device=None) -> Mesh:
    """An in-process mesh of n_shards on one device (None means cuda)."""
    return Mesh(n_shards, device=device)


def pad_edges_to(prob: ba_mod.BAProblem, multiple: int) -> ba_mod.BAProblem:
    """Pad the edge arrays with zero rows (invalid edges) so that they divide
    evenly across `multiple` shards."""
    pad = (-prob.e_kf.shape[0]) % multiple
    if pad == 0:
        return prob

    def p(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    out = {f: p(getattr(prob, f)) for f in _EDGE_FIELDS}
    if prob.e_invd is not None:
        out["e_invd"] = p(prob.e_invd)
    return prob._replace(**out)


def _strip_stereo_rows(prob: ba_mod.BAProblem) -> ba_mod.BAProblem:
    """The sharded solvers carry 2-dim mono rows only; surface the drop: a
    stereo system running post-loop global BA through this path loses its
    metric scale constraint for that pass (route stereo GBA to the
    single-device optim.ba.solve_ba to keep it)."""
    if prob.e_invd is not None:
        warnings.warn(
            "sharded BA: stereo (3-dim) rows stripped — metric scale is "
            "unconstrained in this distributed pass; use the single-chip "
            "solver for stereo global BA.", stacklevel=3)
    return prob._replace(e_invd=None, bf=None)


def _to(prob: ba_mod.BAProblem, dev) -> ba_mod.BAProblem:
    return ba_mod.BAProblem(*[None if a is None else torch.as_tensor(a).to(dev)
                              for a in prob])


def put_problem(prob: ba_mod.BAProblem, mesh: Mesh) -> ba_mod.BAProblem:
    """This process's part of an edge-sharded problem on the mesh's device:
    the edges padded to a multiple of mesh.size, then the contiguous block
    of rows of its n_local shards ([n_local * E/size]); the variables
    replicated (multihost.put_problem)."""
    prob = pad_edges_to(_to(prob, mesh.device), mesh.size)
    es = prob.e_kf.shape[0] // mesh.size
    lo, hi = mesh.rank_offset * es, (mesh.rank_offset + mesh.n_local) * es
    return prob._replace(**{f: getattr(prob, f)[lo:hi] for f in _EDGE_FIELDS},
                         e_invd=None if prob.e_invd is None else prob.e_invd[lo:hi])


def partition_by_landmark(prob: ba_mod.BAProblem, n_shards: int):
    """Landmarks into `n_shards` contiguous blocks of Ls, every edge onto
    the shard that owns its landmark, so that all landmark math is
    shard-local. Returns (prob', Ls): prob' has the landmark arrays padded
    to n_shards*Ls, edges grouped by shard (a stable sort by shard) and each
    group padded to the largest group's count Es with invalid copies of edge
    0, and e_lm rewritten to the index inside the shard's block. Invalid
    edges are grouped like valid ones, as the JAX package does: on a global
    problem every empty slot points at landmark 0, so shard 0 takes nearly
    the whole padded table and every shard is padded to that count."""
    dev = prob.lm_pos.device
    L = prob.lm_pos.shape[0]
    Ls = -(-L // n_shards)
    pad_l = n_shards * Ls - L
    lm_pos, lm_opt = prob.lm_pos, prob.lm_opt_mask
    if pad_l:
        lm_pos = torch.cat([lm_pos, lm_pos.new_zeros((pad_l, 3))])
        lm_opt = torch.cat([lm_opt, lm_opt.new_zeros(pad_l)])
    e_lm = prob.e_lm.long()
    E = e_lm.shape[0]
    shard_of = e_lm // Ls
    counts = torch.bincount(shard_of, minlength=n_shards)
    Es = int(counts.max()) if E else 1     # host read: it sets the shapes
    key, order = torch.sort(shard_of, stable=True)
    start = torch.cumsum(counts, 0) - counts
    slot = key * Es + torch.arange(E, device=dev) - start[key]
    sel = torch.zeros(n_shards * Es, dtype=torch.long, device=dev).index_put_((slot,), order)
    live = torch.zeros(n_shards * Es, dtype=torch.bool, device=dev).index_fill_(0, slot, True)
    prob2 = prob._replace(
        lm_pos=lm_pos, lm_opt_mask=lm_opt,
        e_kf=prob.e_kf[sel], e_lm=(e_lm[sel] % Ls).to(prob.e_lm.dtype),
        e_uv=prob.e_uv[sel], e_valid=prob.e_valid[sel] & live, e_info=prob.e_info[sel])
    return prob2, Ls


def _put_partitioned(prob: ba_mod.BAProblem, mesh: Mesh, Ls: int) -> ba_mod.BAProblem:
    """This process's edge groups and landmark blocks of a partitioned
    problem; the poses replicated."""
    es = prob.e_kf.shape[0] // mesh.size
    lo, hi = mesh.rank_offset, mesh.rank_offset + mesh.n_local
    return prob._replace(lm_pos=prob.lm_pos[lo * Ls:hi * Ls],
                         lm_opt_mask=prob.lm_opt_mask[lo * Ls:hi * Ls],
                         **{f: getattr(prob, f)[lo * es:hi * es] for f in _EDGE_FIELDS})


def _solve(mesh: Mesh, sp: ba_mod.BAProblem, n_lm: int, lm_sharded: bool, cam_kind: int,
           iters: int, cg_iters: int, chi2_th: float, lam0: float):
    """LM + block-Jacobi PCG on this process's shards. sp holds the local
    edges [n_local*Es]; its landmarks are the replicated table [n_lm]
    (edge-sharded) or the local blocks [n_local*n_lm] with e_lm indexing the
    shard's block (lm_sharded). Returns (R, t, X, cost history)."""
    dev = mesh.device
    n = mesh.n_local
    Kw = sp.R_cw.shape[0]
    Es = sp.e_kf.shape[0] // n
    sid = torch.arange(n, device=dev).repeat_interleave(Es)
    e_kf = sp.e_kf.long()
    plan_c = chunked_plan(sid * Kw + e_kf, n * Kw, SEG_CHUNK)

    def seg_c(v):      # pose segments need the cross-shard reduction
        return mesh.psum(seg_sum_chunked(plan_c, v).reshape((n, Kw) + tuple(v.shape[1:])))

    if lm_sharded:
        e_lmx = sid * n_lm + sp.e_lm.long()
        plan_l = chunked_plan(e_lmx, n * n_lm, SEG_CHUNK)

        def seg_l(v):  # landmark segments are shard-local: no collective
            return seg_sum_chunked(plan_l, v)

        def dot_l(a, b):   # disjoint landmark blocks: one scalar psum
            return mesh.psum((a * b).reshape(n, -1).sum(dim=1))
    else:
        e_lmx = sp.e_lm.long()
        plan_l = chunked_plan(sid * n_lm + e_lmx, n * n_lm, SEG_CHUNK)

        def seg_l(v):
            return mesh.psum(seg_sum_chunked(plan_l, v).reshape((n, n_lm) + tuple(v.shape[1:])))

        def dot_l(a, b):   # replicated: the same on every shard
            return torch.sum(a * b)

    sp = sp._replace(e_lm=e_lmx)
    pmask = sp.pose_opt_mask.float()[:, None]
    lmask = sp.lm_opt_mask.float()[:, None]
    me = sp.e_valid.float()
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)

    def chi2_of(R, t, X):
        e, Jc, Jl, depth = ba_mod._edge_terms(cam_kind, sp, R, t, X)
        return torch.sum(e * e, dim=-1) * sp.e_info, e, Jc, Jl, depth

    def cost(chi2):
        return mesh.psum((robust.huber_cost(chi2, chi2_th) * me).reshape(n, Es).sum(dim=1))

    def guard(v):
        return torch.where(torch.abs(v) < 1e-20, torch.full_like(v, 1e-20), v)

    R, t, X = sp.R_cw, sp.t_cw, sp.lm_pos
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    costs = []
    for _ in range(iters):
        chi2, e, Jc, Jl, depth = chi2_of(R, t, X)
        w = (robust.huber_weight(chi2, chi2_th) * sp.e_info * me
             * (depth > 0.05).float())
        we = w[:, None] * e
        g_c = seg_c(torch.einsum("eki,ek->ei", Jc, we)) * pmask
        g_l = seg_l(torch.einsum("eki,ek->ei", Jl, we)) * lmask
        Hcc = seg_c(torch.einsum("eki,e,ekj->eij", Jc, w, Jc))
        Hll = seg_l(torch.einsum("eki,e,ekj->eij", Jl, w, Jl))
        lam_dc = lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6)
        lam_dl = lam * torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-6)
        Hcc_d = torch.where(pmask[:, :, None] > 0, Hcc + torch.diag_embed(lam_dc), eye6)
        Hll_d = torch.where(lmask[:, :, None] > 0, Hll + torch.diag_embed(lam_dl), eye3)
        Pc = inv6(Hcc_d + 1e-9 * eye6)
        Pl = inv3(Hll_d + 1e-9 * eye3)

        def matvec(v_c, v_l):
            v_c = v_c * pmask
            v_l = v_l * lmask
            u = (torch.einsum("eki,ei->ek", Jc, v_c[e_kf])
                 + torch.einsum("eki,ei->ek", Jl, v_l[e_lmx])) * w[:, None]
            out_c = seg_c(torch.einsum("eki,ek->ei", Jc, u)) + lam_dc * v_c
            out_l = seg_l(torch.einsum("eki,ek->ei", Jl, u)) + lam_dl * v_l
            return out_c * pmask, out_l * lmask

        def precond(r_c, r_l):
            return (torch.einsum("kij,kj->ki", Pc, r_c) * pmask,
                    torch.einsum("lij,lj->li", Pl, r_l) * lmask)

        def dot(a_c, a_l, b_c, b_l):
            return torch.sum(a_c * b_c) + dot_l(a_l, b_l)

        b_c, b_l = -g_c, -g_l
        x_c, x_l = torch.zeros_like(b_c), torch.zeros_like(b_l)
        r_c, r_l = b_c, b_l
        p_c, p_l = precond(b_c, b_l)
        rz = dot(b_c, b_l, p_c, p_l)
        for _ in range(cg_iters):
            Ap_c, Ap_l = matvec(p_c, p_l)
            alpha = rz / guard(dot(p_c, p_l, Ap_c, Ap_l))
            x_c = x_c + alpha * p_c
            x_l = x_l + alpha * p_l
            r_c = r_c - alpha * Ap_c
            r_l = r_l - alpha * Ap_l
            z_c, z_l = precond(r_c, r_l)
            rz_new = dot(r_c, r_l, z_c, z_l)
            beta = rz_new / guard(rz)
            p_c = z_c + beta * p_c
            p_l = z_l + beta * p_l
            rz = rz_new

        dR, dt = lie.se3_exp(x_c)
        R_new = lie.normalize_rotation(torch.einsum("kij,kjl->kil", dR, R))
        t_new = torch.einsum("kij,kj->ki", dR, t) + dt
        R_new = torch.where(pmask[:, :, None] > 0, R_new, R)
        t_new = torch.where(pmask > 0, t_new, t)
        X_new = torch.where(lmask > 0, X + x_l, X)
        chi2_new = chi2_of(R_new, t_new, X_new)[0]
        cost_old, cost_new = cost(chi2), cost(chi2_new)
        improved = cost_new < cost_old
        R = torch.where(improved, R_new, R)
        t = torch.where(improved, t_new, t)
        X = torch.where(improved, X_new, X)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0), 1e-8, 1e4)
        costs.append(cost_old)
    return R, t, X, torch.stack(costs)


def solve_ba_sharded(prob: ba_mod.BAProblem, mesh: Mesh, cam_kind: int = cameras.PINHOLE,
                     iters: int = 10, cg_iters: int = 20,
                     chi2_th: float = robust.CHI2_MONO, lam0: float = 1e-4):
    """LM + block-Jacobi PCG with the edges sharded over the mesh and the
    variables replicated. Returns (R_cw, t_cw, lm_pos, cost_history), the
    same on every process; the numerics of optim.ba.solve_ba(solver="pcg",
    phases=1) up to reduction order."""
    prob = _strip_stereo_rows(prob)
    return _solve(mesh, put_problem(prob, mesh), prob.lm_pos.shape[0], False, cam_kind,
                  iters, cg_iters, chi2_th, lam0)


def solve_ba_sharded_lm(prob: ba_mod.BAProblem, mesh: Mesh, cam_kind: int = cameras.PINHOLE,
                        iters: int = 10, cg_iters: int = 20,
                        chi2_th: float = robust.CHI2_MONO, lam0: float = 1e-4):
    """LM + block-Jacobi PCG with the landmark variables sharded too: each
    shard's landmark block and its edges stay shard-local, so a matvec's
    landmark half needs no collective and only the 6K-float pose vector and
    the CG inner products cross shards. Returns (R_cw, t_cw, lm_pos padded
    to mesh.size*Ls and gathered from every process, cost_history)."""
    prob = _strip_stereo_rows(prob)
    prob, Ls = partition_by_landmark(_to(prob, mesh.device), mesh.size)
    R, t, X, costs = _solve(mesh, _put_partitioned(prob, mesh, Ls), Ls, True, cam_kind,
                            iters, cg_iters, chi2_th, lam0)
    return R, t, mesh.all_gather(X), costs
