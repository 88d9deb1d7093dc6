"""Worker process for tests/test_torch_multihost.py: joins a gloo process
group over localhost, solves the parent's BA problem (an npz of
BAProblem fields) over the multi-process mesh with both solvers of
parallel/multihost.py, and (process 0) writes the results for the parent.
Never imports JAX.

Usage: python torch_multihost_worker.py <process_id> <num_processes> <port>
           <n_local> <problem.npz> <out.npz>
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rover_slam_tpu_torch.optim import ba  # noqa: E402
from rover_slam_tpu_torch.parallel import multihost  # noqa: E402


def main(pid, nproc, port, n_local, src, out):
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, backend="gloo")
    try:
        with np.load(src) as z:
            prob = ba.BAProblem(**{k: torch.from_numpy(z[k]) for k in z.files})
        mesh = multihost.global_mesh(n_local=n_local, device="cpu")
        R, t, X, costs = multihost.solve_ba_multihost(prob, mesh, iters=10, cg_iters=25)
        R2, t2, X2, costs2 = multihost.solve_ba_multihost(prob, mesh, lm_sharded=True,
                                                          iters=10, cg_iters=25)
        if pid == 0:
            np.savez(out, R=R.numpy(), t=t.numpy(), X=X.numpy(), costs=costs.numpy(),
                     R_lm=R2.numpy(), t_lm=t2.numpy(), X_lm=X2.numpy(),
                     costs_lm=costs2.numpy(), mesh_size=mesh.size)
        print(f"[worker {pid}] done, cost {float(costs[-1]):.4f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), a[2], int(a[3]), a[4], a[5])
