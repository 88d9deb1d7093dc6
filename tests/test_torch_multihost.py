"""Multi-process distributed BA of the port: two processes, each with 4
local shards on the CPU, joined over gloo on localhost
(tests/torch_multihost_worker.py, which never imports JAX), solve
make_ba_problem(6, 120) from an npz the parent writes. Held to the JAX
package's single-process sharded solvers on its 8 virtual devices within
test_torch_sharded_ba.py's SOLVE tolerances (the reduction order differs:
4 local shards, then the all_reduce), and to tests/test_multihost.py's
asserts."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from rover_slam_tpu.optim import ba as jba
from rover_slam_tpu.parallel import sharded_ba as jsh
from tests.test_ba import make_ba_problem, pose_errors

from test_torch_sharded_ba import SOLVE

pytestmark = pytest.mark.multihost

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    prob, truth, _ = make_ba_problem(Kw=6, Lw=120, noise_px=0.5)
    src, out = str(tmp / "problem.npz"), str(tmp / "result.npz")
    np.savez(src, **{k: np.asarray(v) for k, v in prob._asdict().items() if v is not None})
    env = dict(os.environ, PYTHONPATH=_REPO)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, _WORKER, str(pid), "2", port, "4", src, out],
                              env=env, cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    return prob, truth, res


def test_two_processes_match_jax_single_process(two_processes):
    prob, _, res = two_processes
    assert int(res["mesh_size"]) == 8
    mesh = jsh.make_mesh(8)
    for suffix, solve in (("", jsh.solve_ba_sharded), ("_lm", jsh.solve_ba_sharded_lm)):
        out_j = solve(prob, mesh, iters=10, cg_iters=25)
        for name, b in zip(("R", "t", "X", "costs"), out_j):
            a = res[name + suffix]
            assert a.shape == np.asarray(b).shape, name + suffix
            np.testing.assert_allclose(a, np.asarray(b), err_msg=name + suffix, **SOLVE[name])


def test_two_processes_basin(two_processes):
    """tests/test_multihost.py's asserts."""
    prob, (R_true, t_true, _), res = two_processes
    ref = jba.solve_ba(prob, iters=10, cg_iters=25, solver="pcg", phases=1)
    assert float(res["costs"][-1]) < float(ref.cost_history[0])
    assert np.linalg.norm(res["R"] - np.asarray(ref.R_cw)) < 1e-2
    ang, dte = pose_errors(res["R"], res["t"], R_true, t_true)
    assert ang.max() < 0.2 and dte.max() < 0.05
    assert float(res["costs_lm"][-1]) < float(ref.cost_history[0])
    ang2, dte2 = pose_errors(res["R_lm"], res["t_lm"], R_true, t_true)
    assert ang2.max() < 0.2 and dte2.max() < 0.05
