"""bench_scaling_port.py, the port's twin of bench_scaling.py, on the CPU.

build_problem() against bench_scaling.build_problem() (the JAX package on
the CPU): the seeded integer arrays, masks and landmark positions equal to
the bit; the poses go through each package's se3_exp (XLA's and torch's
sin / cos), within 1e-6; the measured pixels through each package's
projection, within 1e-5 of max(1, |uv|) on the valid edges and 1e-4 on the
edges behind or at the camera (z <= 0.2, left out of every solve), where
the division by a small depth amplifies the poses' difference. The sweep
runs at a cut size (16 keyframes, 512 landmarks) on meshes of 1 and 2
shards, and the two-process path as two CPU processes on a gloo group."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_scaling
import bench_scaling_port
import torch_parity  # noqa: F401  (its import sets one torch thread a test worker)


def test_build_problem_equals_bench_scaling():
    pj, pt = bench_scaling.build_problem(), bench_scaling_port.build_problem()
    assert pt.e_kf.shape[0] == 8192 * 8
    for f in ("pose_opt_mask", "lm_pos", "lm_opt_mask", "cam_params", "e_kf", "e_lm",
              "e_valid", "e_info"):
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("R_cw", "t_cw"):
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    uv, ref = pt.e_uv.numpy(), np.asarray(pj.e_uv)
    assert uv.dtype == ref.dtype == np.float32
    err = np.abs(uv - ref).max(1) / np.maximum(1.0, np.abs(ref).max(1))
    valid = pt.e_valid.numpy()
    assert err[valid].max() <= 1e-5 and err[~valid].max() <= 1e-4


def test_sweep_at_a_cut_size(capsys):
    lines = bench_scaling_port.single_process_sweep(device="cpu", sizes=(1, 2), reps=1,
                                                    Kw=16, Lw=512)
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    assert [(x["metric"], x["devices"]) for x in lines] == [
        ("sharded_ba_ms", 1), ("lm_sharded_ba_ms", 1), ("sharded_ba_ms", 2),
        ("lm_sharded_ba_ms", 2)]
    for x in lines:
        assert x["unit"] == "ms" and x["value"] > 0 and x["edges"] == 512 * 8
        assert x["backend"] == "cpu" and x["device"]["count"] == 0
        assert "not scaling" in x["note"]
    assert lines[0]["speedup_vs_1dev"] == 1.0
    assert lines[2]["speedup_vs_1dev"] == pytest.approx(lines[0]["value"] / lines[2]["value"])


def test_two_processes_at_a_cut_size():
    """multiprocess_worker in two processes (gloo on localhost, 4 CPU shards
    each), as --processes 2 runs it on the card: process 0 prints the line."""
    root = pathlib.Path(__file__).resolve().parents[1]
    port = bench_scaling_port.free_port()
    code = ("import torch, bench_scaling_port as b; torch.set_num_threads(1); "
            "b.multiprocess_worker({pid}, 2, {port}, device='cpu', reps=1, Kw=16, Lw=512)")
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code.format(pid=pid, port=port)], cwd=root,
                              env=env, stdout=subprocess.PIPE, text=True) for pid in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[1].strip() == ""
    line = json.loads(outs[0].strip().splitlines()[-1])
    assert (line["metric"], line["processes"], line["devices"], line["edges"]) == (
        "sharded_ba_ms_multiprocess", 2, 8, 512 * 8)
    assert line["backend"] == "cpu" and line["value"] > 0 and "not scaling" in line["note"]


def test_scripts_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_scaling_port.main([]) == 1
    assert bench_scaling_port.main(["--processes", "2"]) == 1
