"""Multi-process distributed bundle adjustment on torch.distributed.

Counterpart of rover_slam_tpu/parallel/multihost.py. Each process joins one
process group (`initialize`), holds `n_local` shards on its device
(`global_mesh`), keeps the same full host problem (the SLAM state is
replicated across processes) and solves only its block of edges, or of
landmarks and their edges; the psums of parallel/sharded_ba.py become
all_reduces over the group. Nothing in the solver changes.

Start one process per host or card:
    initialize("<host0>:<port>", num_processes=N, process_id=i)
tests/test_torch_multihost.py runs two CPU processes over gloo.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import sharded_ba
from .sharded_ba import put_problem  # noqa: F401  (the JAX module's API)


def initialize(coordinator: str, num_processes: int, process_id: int, backend=None):
    """Join this process into the group of num_processes processes that
    rendezvous at coordinator ("host:port"). backend None: NCCL when the
    process has a CUDA device, gloo on the CPU."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)


def global_mesh(n_local: int = 1, device=None) -> sharded_ba.Mesh:
    """A mesh of n_local shards on `device` (None means cuda) in every
    process of the default group."""
    return sharded_ba.Mesh(n_local, device=device, group=dist.group.WORLD)


def solve_ba_multihost(prob, mesh: sharded_ba.Mesh | None = None,
                       lm_sharded: bool = False, **kw):
    """Edge-sharded LM-PCG BA over the multi-process mesh (the same numerics
    as solve_ba_sharded); every process gets the same outputs.
    lm_sharded=True: landmarks sharded too (solve_ba_sharded_lm), lm_pos
    gathered to the full [mesh.size*Ls, 3] on every process."""
    mesh = mesh if mesh is not None else global_mesh()
    if lm_sharded:
        return sharded_ba.solve_ba_sharded_lm(prob, mesh, **kw)
    return sharded_ba.solve_ba_sharded(prob, mesh, **kw)
