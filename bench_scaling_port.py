"""Distributed-BA sweep of the PyTorch / CUDA port: solve time against mesh
size, in one process and in two. The twin of bench_scaling.py.

    python3 bench_scaling_port.py                 # meshes of 1, 2, 4 and 8 shards
    python3 bench_scaling_port.py --processes 2   # two processes of 4 shards each

Needs a CUDA device (exits 1 without one). The problem is bench_scaling.py's
(build_problem: 64 keyframes, 8192 landmarks, 8 observations a landmark,
seeded), built with numpy and the port's lie / cameras. The single-process
sweep times parallel/sharded_ba.py's solve_ba_sharded (edges sharded) and
solve_ba_sharded_lm (landmarks sharded too), 6 LM steps of 15 CG iterations,
on make_mesh(n) for n = 1, 2, 4 and 8: one warm-up solve, then the mean of 3,
each ended by a device synchronize. --processes 2 spawns two workers that
join one gloo group on localhost (parallel/multihost.py; gloo takes CUDA
tensors, and NCCL runs one rank a card) and solve on global_mesh(4); process
0 reports. Each run prints bench_scaling.py's JSON lines (sharded_ba_ms with
speedup_vs_1dev, lm_sharded_ba_ms, sharded_ba_ms_multiprocess), with backend
the card's name and device its power limit.

Every shard of every mesh here lives on the one card: the lines measure what
sharding costs (the per-shard loops, the psums, in two processes gloo's
host round trips), not how the solve scales over cards.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ITERS, CG_ITERS, REPS = 6, 15, 3
NOTE = ("every shard on one card: measures sharding overhead, not scaling "
        "over cards")


def build_problem(Kw: int = 64, Lw: int = 8192, obs_per_lm: int = 8):
    """bench_scaling.py's seeded BA problem (every process builds the same):
    Lw landmarks in a box 5-25 m ahead, Kw keyframes stepping along x and
    turning about y, obs_per_lm observations a landmark by random keyframes
    with 0.5 px noise, edges valid in front of the camera, keyframes 2 on
    perturbed by 0.02 in the tangent space, landmarks by 5 cm."""
    from rover_slam_tpu_torch.geometry import cameras, lie
    from rover_slam_tpu_torch.optim import ba

    def se3(xi):
        R, t = lie.se3_exp(torch.from_numpy(np.asarray(xi, np.float32)))
        return R.numpy(), t.numpy()

    rng = np.random.default_rng(0)
    cam = cameras.make_pinhole(458.654, 457.296, 367.215, 248.375)
    Xw = np.stack([rng.uniform(-8, 8, Lw), rng.uniform(-6, 6, Lw),
                   rng.uniform(5, 25, Lw)], 1).astype(np.float32)
    R_t, t_t = zip(*(se3([0.05 * k, 0.01 * k, 0, 0, 0.01 * k, 0]) for k in range(Kw)))
    R_t, t_t = np.stack(R_t), np.stack(t_t)
    e_lm = np.repeat(np.arange(Lw), obs_per_lm).astype(np.int32)
    e_kf = rng.integers(0, Kw, len(e_lm)).astype(np.int32)
    Xc = np.einsum("eij,ej->ei", R_t[e_kf], Xw[e_lm]) + t_t[e_kf]
    uv = cameras.project(cameras.PINHOLE, cam, torch.from_numpy(Xc)).numpy()
    uv += rng.normal(0, 0.5, uv.shape)              # in place: stays float32, as there
    ok = Xc[:, 2] > 0.2
    R0, t0 = R_t.copy(), t_t.copy()
    for k in range(2, Kw):
        dR, dt = se3(rng.normal(0, 0.02, 6).astype(np.float32))
        R0[k] = dR @ R0[k]
        t0[k] = dR @ t0[k] + dt
    lm_pos = Xw + rng.normal(0, 0.05, Xw.shape).astype(np.float32)
    t = torch.from_numpy
    return ba.BAProblem(
        R_cw=t(R0), t_cw=t(t0), pose_opt_mask=t(np.arange(Kw) >= 2), lm_pos=t(lm_pos),
        lm_opt_mask=torch.ones(Lw, dtype=torch.bool), cam_params=cam, e_kf=t(e_kf),
        e_lm=t(e_lm), e_uv=t(uv), e_valid=t(ok),
        e_info=torch.ones(len(e_kf), dtype=torch.float32))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def device_fields(dev) -> dict:
    """backend (the device's name) and device (name, power limit, count)."""
    from bench_port import device_info
    info = device_info(dev)
    return {"backend": info["name"], "device": info}


def time_solve(run, dev, reps: int = REPS) -> float:
    """ms a solve: one warm-up, then the mean of `reps`, each ended by a
    device synchronize."""
    run()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
        _sync(dev)
    return (time.perf_counter() - t0) / reps * 1000.0


def single_process_sweep(device=None, sizes=(1, 2, 4, 8), reps: int = REPS,
                         **problem) -> list:
    """The sweep's lines (also printed), one pair per mesh size."""
    from rover_slam_tpu_torch.parallel import sharded_ba
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    prob = build_problem(**problem)
    n_edges = int(prob.e_kf.shape[0])
    fields = device_fields(dev)
    lines, base = [], None
    for n in sizes:
        mesh = sharded_ba.make_mesh(n, device=dev)
        ms = time_solve(lambda: sharded_ba.solve_ba_sharded(
            prob, mesh, iters=ITERS, cg_iters=CG_ITERS), dev, reps)
        base = ms if base is None else base
        lines.append({"metric": "sharded_ba_ms", "value": ms, "unit": "ms", "devices": n,
                      "edges": n_edges, **fields, "speedup_vs_1dev": base / ms, "note": NOTE})
        print(json.dumps(lines[-1]), flush=True)
        ms_lm = time_solve(lambda: sharded_ba.solve_ba_sharded_lm(
            prob, mesh, iters=ITERS, cg_iters=CG_ITERS), dev, reps)
        lines.append({"metric": "lm_sharded_ba_ms", "value": ms_lm, "unit": "ms",
                      "devices": n, "edges": n_edges, **fields, "note": NOTE})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def multiprocess_worker(pid: int, nproc: int, port: int, device=None, n_local: int = 4,
                        reps: int = REPS, **problem):
    """One process of the group: the edge-sharded solve over global_mesh(
    n_local) of every process; process 0 prints (and returns) the line."""
    import torch.distributed as dist
    from rover_slam_tpu_torch.parallel import multihost
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, backend="gloo")
    try:
        prob = build_problem(**problem)
        mesh = multihost.global_mesh(n_local, device=dev)
        ms = time_solve(lambda: multihost.solve_ba_multihost(
            prob, mesh, iters=ITERS, cg_iters=CG_ITERS), dev, reps)
        line = {"metric": "sharded_ba_ms_multiprocess", "value": ms, "unit": "ms",
                "processes": nproc, "devices": mesh.size, "edges": int(prob.e_kf.shape[0]),
                **device_fields(dev), "collectives": "gloo over localhost", "note": NOTE}
        if pid == 0:
            print(json.dumps(line), flush=True)
        return line
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_multiprocess(nproc: int, timeout_s: float = 300.0) -> int:
    """nproc workers of this script on one gloo group; 0 when all exit 0.
    Workers still running at the deadline are killed."""
    port = str(free_port())
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, "--worker", str(pid), str(nproc), port])
             for pid in range(nproc)]
    t0 = time.perf_counter()
    try:
        rc = [p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0))) for p in procs]
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rc is None or any(rc):
        print(f"bench_scaling_port.py: workers failed: {rc}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("bench_scaling_port.py: no CUDA device", file=sys.stderr)
        return 1
    if "--worker" in argv:
        i = argv.index("--worker")
        multiprocess_worker(int(argv[i + 1]), int(argv[i + 2]), int(argv[i + 3]))
        return 0
    if "--processes" in argv:
        return spawn_multiprocess(int(argv[argv.index("--processes") + 1]))
    single_process_sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
