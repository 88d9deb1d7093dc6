"""Chip smoke test of the PyTorch / CUDA port (rover_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases below; any failure raises and the script exits non-zero. Phases 1-3
run first, alone on the card. Then two worker processes (`--worker H,I,K`
and `--worker F,J`, see WORKER_GROUPS) run paths H, I, K and F, J beside
the main process's paths A, B, C, D and G's pipelined run; the main process
reads their launches and seconds by phase when they end, and fails if one
does. Last, alone on the card, the main process runs paths E, M, L and G's
synchronous runs.
  1. build   — nvcc builds every CUDA kernel of the port from csrc/.
  2. parity  — each kernel against its plain PyTorch version on the card, at
               the paths' shapes (B1 at B=1, 2, 3; B2 at the SuperPoint size
               and at relocalization's 1024 x 16384 x 256 and 16384 x 1024 x
               256) and at the edges of the kernels' tilings; B1's autograd
               Function (forward on the kernel, backward by recompute) at
               path K2's shape against plain autograd.
  3. timing  — each kernel at the main path's shapes beside its bound, its
               plain version and a library call that computes the same thing,
               timed on the device by CUDA-graph replay (cuda_time_ms);
               pose_opt at the tracker's two calls (M = 1024, mono pinhole,
               2 x 5 and 2 x 6) beside its plain twin, which syncs and is
               timed eagerly (eager_time_ms).
  4. lightglue — path A frame pairs through LightGlueMatcher, with the
               kernel and with two plain attentions swapped in: the matches
               must agree with the plain attention at the kernel's precision
               and, within looser limits, with the plain version.
  5. path A  — the bench scene at full width: 480x640 images -> SuperPoint
               (1024 keypoints, 256-D, shipped weights) -> LightGlue (9
               layers, shipped weights) as the frame matcher -> synchronous
               monocular tracking and mapping (capacities 512/1024/16384),
               80 frames.
  6. path B  — the package's default configuration (mutual-NN matching) on
               the synthetic oracle world; ATE must stay under 3 cm. Two
               tails: the kidnapped robot (global relocalization through B2
               against the landmark table) and slot recycling on small tables
               (culling, compaction).
  7. path C  — bench.py's tracker: path A's scene at its full 160 frames,
               pipeline=4 (fused track+map, flags read four frames late),
               40 warm-up frames, flush, precompile, 120 timed frames, flush.
               Run once (path E runs the same tracker twice, one digest).
  8. path D  — relocalization at full width: a path C system to frame 60,
               four frames on which tracking fails, then frames 20 onward
               again: tracking must go RECENTLY_LOST and come back OK through
               relocalization (B1 at B=3 over the newest keyframes).
  9. path E  — bench.py's full configuration, bench_port.py's loop (the
               twin of bench.py, whose scene, loop and digest this path
               imports): path C with loop closing on
               (LoopConfig(min_covis_weight=30): place recognition, Sim3
               verification with B2 at 1024 x 1024 x 256 per candidate, the
               fire-time LightGlue match, essential-graph correction, chunked
               global BA). Run twice: one trajectory digest, >= 90 % of
               frames tracked, and a loop must fire. Prints bench.py's detail
               fields.
 10. path F  — tests/test_loop_closing_e2e.py's loop scene (ring world,
               100 frames over 1.25 revolutions, mutual-NN matching, tables
               128 / 512 / 16384), once synchronous and once with pipeline=4:
               a loop fires back to an early keyframe at a scale in (0.5, 2)
               and the ATE stays under 5 cm. Then the merge tail:
               tests/test_multisession.py's warped two-session scene, merged
               through the loop closer's cross-map branch; the far end of the
               absorbed map must come back within 0.35 of the injected drift.
 11. path G  — the monocular-inertial system at full width: path A's scene
               on orbit_with_imu's trajectory (1.1 revolutions over 160
               frames at 1/30 s, radial wobble and vertical bob, IMU at
               200 Hz, camera = body, tests/test_e2e_inertial.py's IMU
               calibration), MonocularInertialSLAM(tinit_s=2.0), loop
               closing on with LoopConfig(min_covis_weight=30,
               fix_scale=True). Pipeline=4 once over the first
               G_PIPELINED_FRAMES frames (beside the workers), then
               synchronous twice (one trajectory digest; alone on the
               card). Each run must initialize the IMU,
               refine frames and run VI-BA after the init and launch B1 and
               B2; the synchronous runs must track >= 90 % of their frames
               and keep the metric ATE (Horn without scale, over the frames
               after the init) under G_ATE_BOUND_CM; the pipelined run, whose
               reference loses tracking after the init, >= 90 % up to it.
               Each run logs the frames that fired a loop and the scale log.
 12. path H  — the EuRoC app (rover_slam_tpu_torch.apps.run_euroc) on the
               card: path G's scene written as an EuRoC tree (H_FRAMES
               frames, PGM images, imu0/data.csv, gt.txt), a reference-style
               settings file (1024 features, path G's IMU noise, loop
               closing, System.SaveAtlasToFile) and the shipped weights as
               official-layout checkpoints; session 1 monocular-inertial
               with --gt, --stats-out and --frame-log (image read, extract
               and track times a frame); the atlas through the checksum
               gate; the ATE CLI on session 1's TUM file; session 2 resumes
               the atlas through System.LoadAtlasFromFile for a short
               monocular run. Gates in phase_path_h.
 13. path I  — StereoSLAM at full width: path C's scene rendered as
               rectified stereo pairs (baseline I_BASELINE), both eyes
               through SuperPoint as one batch, LightGlue as the frame
               matcher, loop closing on with LoopConfig(fix_scale=True,
               min_covis_weight=30). Run once (its trajectory digest
               printed), >= 90 % of frames tracked, the metric ATE (no
               scale alignment) under I_ATE_BOUND_CM, a loop fired, B1 and
               B2 launched. Then RGBDSLAM over the first I_RGBD_FRAMES frames
               with the renderer's true depth at the keypoints plus 1 cm of
               noise: the metric path length within 8 % of the truth.
 14. path J  — J1: the EuRoC app with --sensor stereo-inertial on path H's
               scene written as a rectified stereo tree (cam1/ at
               J_BASELINE) with path H's settings plus Stereo.T_c1_c2: a
               StereoInertialSLAM, both eyes through SuperPoint as one
               batch, LightGlue as the frame matcher, loop closing on. It
               must return 0, track >= J_TRACKED_MIN of its frames,
               initialize the IMU, launch B1 and B2 and keep the metric
               ATE under J_ATE_BOUND_CM; it prints fps, frame times, the
               init frame, the biases, the stereo matches a frame, the
               landmarks spawned at stereo depth, both eyes' image reads
               and the digest. J2, no networks: FisheyeStereoSLAM on
               tests/test_fisheye_stereo.py's KB8 scene (metric ATE under
               its 10 cm), then FisheyeStereoInertialSLAM on
               tests/test_fisheye_inertial.py's IMU scene with a right eye
               (the IMU initialized, metric ATE after the init under
               J2_SI_ATE_BOUND_CM); both end in OK, and every stereo
               frame's fisheye match launches B2 at 512 x 512 x 64.
 15. path K  — the front-end trainers at the JAX trainers' widths (240x320,
               batch 4), cut in steps and data: K1, superpoint_train.train
               (lr 1e-3, K1_POOL pairs, K1_STEPS steps), then its held-out
               mutual-NN evaluation through B2; K2, lightglue_train.train on
               the shipped SuperPoint weights (9 layers, 512 keypoints, lr
               2e-4, K2_PAIRS pairs, K2_STEPS steps), every attention call's
               forward on B1 and its gradient by recompute, then its
               held-out evaluation; K3, save_params of K2's parameters and
               load_params back into a LightGlueMatcher that matches a
               held-out pair exactly as the trained model does; K4, the
               demo with --trace. Before them, K2's gradient with B1 against
               the same model with the plain attentions swapped in. Gates
               in phase_path_k.
 16. path L  — the distributed back end (parallel/), run right after path
               E on its scene. L2: path E's configuration once more with
               MonocularSLAM(mesh=make_mesh(8)): the same loop event as
               path E run 1 and every pose logged before it equal to the
               bit, then the post-loop global BA landmark-sharded over the
               8 shards; >= 90 % tracked, ATE under L_ATE_BOUND_CM; the
               fire frame's and the GBA chunk frames' ms, peak memory. L1:
               L2's final map as one global problem (the 512 x 1024 padded
               table) through solve_ba(pcg, phases=1), solve_ba_sharded and
               solve_ba_sharded_lm on make_mesh(8): both sharded final costs
               under the initial cost, active keyframes within L_DT_BOUND
               of the single solve, a second edge-sharded run equal to the
               bit (the landmark-sharded solve's second run is L3's NCCL
               process).
               L3: that problem through an npz into two spawned gloo
               processes (4 shards each on the card) and one NCCL process
               (8 shards), solve_ba_multihost both ways: gloo within
               L_DT_BOUND and L3_COST_RTOL of L1, NCCL equal to L1 to the
               bit. L4: entry.dryrun_multichip(8) and entry()'s front-end
               step once. Gates in phase_path_l.
 17. path M  — the profiling twins' stage functions, run right after path
               E on E run 1's final map (bench.py's configuration, 160
               frames, the loop fired): one pass (a warm-up call, a counted
               call and one timed call a line) of profile_stages_port.py's
               programs other than SuperPoint and the LightGlue pair (the
               fused track+map program without and with the insert, the
               loop closer's detect program, match_batch at B =
               n_candidates, the Sim3-candidates program with the learned
               and the mutual-NN matches) and of profile_insert_port.py's
               split of the keyframe insert (the full insert with 2, 1 and
               no BA iterations, covisibility, the pair triangulations,
               fusion, descriptors, the BA window, local BA at 1, 2 and 4
               iterations, the statistics tail). Every stage time finite
               and positive, the full insert adds one keyframe, the pair
               triangulations launch B2, match_batch launches B1 at B =
               n_candidates, and each stage's outputs agree to the bit over
               its two untimed calls on fresh clones of the map. Gates in
               phase_path_m.
Then one JSON line of kernels, the card's name and power limit, and a last
line {"ok": true, "device": {...}}. Needs a CUDA device; never imports JAX.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# The bench scene and loop (paths A, C, D, E and L2) live in bench_port.py,
# the port's headline benchmark: one copy of the loop for both scripts.
from bench_port import (D, FX, H, LIGHTGLUE_LAYERS, NK, RELOC_L, W, PathA, _ate_cm,
                        _launches, _reset_launches, _sync, _tracked, card, log, loop_summary,
                        run_path_c, trajectory_digest)

from rover_slam_tpu_torch.utils.profiling import counter, reset_counters, snapshot_counters

# Published H100 SXM peaks (bf16 dense tensor rate, HBM3 bandwidth, f32
# outside the tensor cores).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ATTN_TOL = 0.02          # bf16 attention vs plain (tests/test_pallas_attention.py)
# best / second-best d^2: kernel and plain multiply the same bf16-rounded
# inputs exactly and sum in f32, so they differ only in summation order.
NN_VALUE_TOL = 1e-4
# LightGlue matches0 with the kernel against a plain attention. The bf16
# network turns any change in the attention's rounding into different matches
# for a few percent of the matched keypoints: the two plain attentions below,
# which differ only in precision, agree on 90-95 % of them (PERF.md). The
# limits sit under the readings, so this phase catches a kernel that breaks
# LightGlue at full width; the parity phase holds each call to ATTN_TOL.
LIGHTGLUE_AGREE = 0.92       # matched keypoints, against masked_attention_f32p
LIGHTGLUE_AGREE_REF = 0.88   # matched keypoints, against masked_attention_plain
LIGHTGLUE_AGREE_ALL = 0.98   # all keypoints, against masked_attention_plain
# Path G: tests/test_e2e_inertial.py's IMU calibration (per-sample sigmas at
# 200 Hz) and orbit_with_imu's simulated biases.
IMU_HZ = 200.0
IMU_CALIB = dict(sigma_g=1.7e-4 * math.sqrt(IMU_HZ), sigma_a=2e-3 * math.sqrt(IMU_HZ),
                 walk_g=1.9e-5 / math.sqrt(IMU_HZ), walk_a=3e-3 / math.sqrt(IMU_HZ))
BG_TRUE, BA_TRUE = (0.002, -0.001, 0.003), (-0.02, 0.03, 0.01)
# Metric ATE bound of path G: 2.6x the larger CPU reading of
# parity_fullwidth.py --inertial --frames 120 (JAX 3.82 cm, port 5.70 cm).
G_ATE_BOUND_CM = 15.0
# The pipelined run is gated up to the IMU init (frame 60-64) and loses
# tracking some 10 frames after it, as the reference does; its frames past
# 80 were relocalization attempts only, cut to keep the script in its time
# limit with path L.
G_PIPELINED_FRAMES = 80
# Path H: the EuRoC app on path G's scene written as an EuRoC tree.
H_FRAMES = 120
H_RESUME_FRAMES = 30
# Metric ATE bound of path H (the app's own: Horn without scale over every
# frame): about 2x the larger CPU reading of parity_fullwidth.py --app
# --frames 120 (JAX 23.28 cm, port 20.97 cm; both IMU inits at frame 60).
H_ATE_BOUND_CM = 50.0
H_TRACKED_MIN = 0.9
# Path I: StereoSLAM on path C's scene rendered as rectified stereo pairs.
I_BASELINE = 0.11          # m, EuRoC's
I_TRACKED_MIN = 0.9
# Metric ATE bound of path I (Horn without scale over every frame): about 2x
# the larger CPU reading of parity_fullwidth.py --stereo --frames 160 (JAX
# 4.57 cm, port 6.45 cm; both fire one loop).
I_ATE_BOUND_CM = 13.0
I_RGBD_FRAMES = 40
I_RGBD_PATH_TOL = 0.08     # tests/test_map_extras.py's TestRGBD gate
# Path J: the stereo-inertial EuRoC app on path H's scene as a rectified
# stereo tree, then the fisheye tail.
J_BASELINE = 0.11          # m, EuRoC's
J_TRACKED_MIN = 0.9
# Metric ATE bound of J1 (the app's: Horn without scale over every frame,
# the 30 frames before the IMU init included): twice the larger CPU reading
# of parity_fullwidth.py --app --sensor stereo-inertial --frames 120 (JAX
# 44.61 cm, port 42.01 cm; both IMU inits at frame 30).
J_ATE_BOUND_CM = 89.2
# Metric ATE bound of J2's FisheyeStereoInertialSLAM (frames after the init):
# twice the JAX package's CPU reading on the same scene
# (parity_fullwidth.py --fisheye-stereo-inertial: JAX 19.02 cm, port 18.91 cm).
J2_SI_ATE_BOUND_CM = 38.0


# Path K: the trainers at the JAX trainers' widths, cut in steps and data.
K_HW = (240, 320)
K1_POOL, K1_STEPS = 16, 30
K2_PAIRS, K2_STEPS = 16, 30
K_TIMED_FROM = 3          # step times: the median over the steps from this one
K_DEMO_FRAMES = 8          # the traced demo, kept short for the script's time limit
# K2's gradient with B1 against the plain attentions, per parameter tensor.
K_GRAD_COS = 0.99


def masked_attention_f32p(q, k, v, mask_kv):
    """Plain attention at the kernel's precision: the bf16 inputs' scores,
    softmax weights and P V all in f32 (the kernel keeps S in f32 and carries
    P as two bf16 terms; masked_attention_plain rounds S and P to bf16)."""
    from rover_slam_tpu_torch.ops import flash_attention as fa
    q = fa._scale_q(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = torch.where(mask_kv[:, None, None, :], s, fa.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def cuda_time_ms(fn, calls: int = 20, replays: int = 10, readings: int = 5) -> float:
    """Device time of one call of fn, by CUDA-graph replay: after a warm-up on
    a side stream, `calls` calls are captured into one graph; each reading
    times `replays` replays with events; the median of `readings` readings,
    per call. Host enqueue cost is not in it. A failed capture raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(readings):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(replays):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / (replays * calls))
    del graph
    return float(np.median(times))


def eager_time_ms(fn, calls: int = 5, readings: int = 5) -> float:
    """Time of one eager call of fn, host enqueue and syncs included (for a
    plain version that syncs and so cannot be captured in a graph): events
    around `calls` calls after a warm-up, the median of `readings`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(readings):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_build():
    """nvcc for every source, then each kernel's ptxas report (registers,
    shared memory, spills) from the build logs."""
    from rover_slam_tpu_torch.ops import _build
    t0 = time.perf_counter()
    took = _build.build()
    log(f"# build: {time.perf_counter() - t0:.1f} s wall, per source {took}")
    for name in _build.SOURCES:
        path = os.path.join(_build.BUILD_DIR, name + ".log")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            lines = f.readlines()
        fn = frame = None
        for line in lines:
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "bytes stack frame" in line:
                frame = line.strip()
            elif "Used" in line and "registers" in line and fn:
                log(f"# ptxas {_kernel_name(fn)}: {line.split(':', 1)[1].strip()}; {frame}")


def _kernel_name(mangled: str) -> str:
    """'..._15flash_tc_kernelILi64EEEv...' -> 'flash_tc_kernel<64>'."""
    m = re.search(r"\d+([A-Za-z_]+kernel)(?:I((?:f|Li\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = ["float" if a.group(1) else a.group(2)
            for a in re.finditer(r"(f)|Li(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def attention_inputs(g, B, N, dev, Hh=4, Dh=64, Nk=None):
    Nk = N if Nk is None else Nk
    q = torch.randn(B, N, Hh, Dh, generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn(B, Nk, Hh, Dh, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    mask = (torch.rand(B, Nk, generator=g) > 0.2).to(dev)
    return q, k, v, mask


def nn_inputs(g, N0, N1, Dd, dev):
    d0 = torch.nn.functional.normalize(torch.randn(N0, Dd, generator=g), dim=1)
    perm = torch.randperm(N0, generator=g)[:min(N0, N1)]
    d1 = torch.nn.functional.normalize(torch.randn(N1, Dd, generator=g), dim=1)
    d1[:len(perm)] = torch.nn.functional.normalize(
        d0[perm] + 0.05 * torch.randn(len(perm), Dd, generator=g), dim=1)
    v0 = torch.ones(N0, dtype=torch.bool)
    v0[int(0.95 * N0):] = False
    v1 = torch.ones(N1, dtype=torch.bool)
    v1[int(0.95 * N1):] = False
    return d0.to(dev), v0.to(dev), d1.to(dev), v1.to(dev)


def _attention_case(fa, name, q, k, v, mask, masked_row=None):
    """Kernel against plain on one input; a batch row whose kv is all masked
    must also equal the mean of v over Nk. Returns the max abs error."""
    out = fa.masked_attention(q, k, v, mask)
    torch.cuda.synchronize()
    ref = fa.masked_attention_plain(q, k, v, mask)
    err = float((out.float() - ref.float()).abs().max())
    msg = f"# parity attention {name}: max abs err {err:.3g}"
    ok = err < ATTN_TOL
    if masked_row is not None:
        mean_v = v[masked_row].float().mean(dim=0)
        err_m = float((out[masked_row].float() - mean_v).abs().max())
        msg += f", all-masked row vs mean(v) {err_m:.3g}"
        ok = ok and err_m < ATTN_TOL
    log(msg)
    if not ok:
        raise AssertionError(f"attention {name} disagrees with plain (tol {ATTN_TOL})")
    return err


def _attention_grad_case(fa, g, dev, dtype):
    """B1 under autograd (ops.flash_attention.KernelAttention) at path K2's
    shape, B=4, N=512, H=4, Dh=64, with padded keys and one all-masked row:
    the output has a grad_fn, the forward is within ATTN_TOL of the plain
    version, and dq, dk, dv for one upstream gradient equal plain autograd's
    to the bit (the backward is the plain version's autograd). Returns the
    forward's max abs error."""
    q, k, v, mask = attention_inputs(g, 4, 512, dev)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    mask[:, 448:] = False
    mask[3] = False
    up = torch.randn(q.shape, generator=g).to(dev, dtype)
    a = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n_fwd, n_bwd = counter("attention_launches"), counter("backward_recomputes")
    out = fa.masked_attention(*a, mask)
    if out.grad_fn is None or counter("attention_launches") != n_fwd + 1:
        raise AssertionError("attention under grad: no kernel launch with a grad_fn")
    out.backward(up)
    ref = fa.masked_attention_plain(*b, mask)
    ref.backward(up)
    torch.cuda.synchronize()
    err = float((out.detach().float() - ref.detach().float()).abs().max())
    same = [torch.equal(x.grad, y.grad) for x, y in zip(a, b)]
    log(f"# parity attention grad {dtype} B=4 N=512: forward max abs err {err:.3g}, "
        f"dq/dk/dv equal to the bit {same}, backward recomputes "
        f"{counter('backward_recomputes') - n_bwd}")
    if not (err < ATTN_TOL and all(same) and counter("backward_recomputes") == n_bwd + 1):
        raise AssertionError(f"attention gradient {dtype} disagrees with plain autograd")
    return err


def _nn_case(nm, name, d0, d1, v1, ties=()):
    """Kernel against plain: best and second within NN_VALUE_TOL, argmin
    identical wherever the plain best and second differ by more than it;
    `ties` rows (row, lower, higher) have exact duplicate best columns, where
    the lower index must win and second must equal best."""
    best, idx, second = nm.nn_reduce(d0, d1, v1)
    torch.cuda.synchronize()
    best_p, idx_p, second_p = nm.nn_reduce_plain(d0, d1, v1)
    e_b = float((best - best_p).abs().max())
    e_s = float((second - second_p).abs().max())
    sep = (second_p - best_p) > NN_VALUE_TOL
    idx_bad = int((idx != idx_p)[sep].sum())
    log(f"# parity nn {name}: best err {e_b:.3g}, second err {e_s:.3g}, "
        f"argmin differs on {idx_bad} of {int(sep.sum())} separated rows")
    if not (e_b < NN_VALUE_TOL and e_s < NN_VALUE_TOL and idx_bad == 0):
        raise AssertionError(f"nn matcher {name} disagrees with plain")
    for r, lo, hi in ties:
        if not (int(idx[r]) == lo and float(second[r]) == float(best[r])
                and int(idx_p[r]) == lo):
            raise AssertionError(f"nn matcher {name}: tie at row {r} between columns "
                                 f"{lo} and {hi} gave idx {int(idx[r])}, best "
                                 f"{float(best[r])}, second {float(second[r])}")
    return max(e_b, e_s)


def phase_parity(dev):
    from rover_slam_tpu_torch.ops import flash_attention as fa, nn_matcher as nm
    g = torch.Generator().manual_seed(0)
    attn_err = 0.0
    # B=2 with row 1 all masked, at the path's N and the tile edges.
    for N in (1, 65, 1000, 1024, 1280):
        for Dh in (32, 64):
            q, k, v, mask = attention_inputs(g, 2, N, dev, Dh=Dh)
            mask[1] = False
            attn_err = max(attn_err, _attention_case(
                fa, f"B=2 N={N} Dh={Dh}", q, k, v, mask, masked_row=1))
    for Nq, Nk in ((1024, 65), (65, 1280), (1, 1000), (1000, 1)):
        q, k, v, mask = attention_inputs(g, 2, Nq, dev, Nk=Nk)
        mask[1] = False
        attn_err = max(attn_err, _attention_case(
            fa, f"B=2 Nq={Nq} Nk={Nk}", q, k, v, mask, masked_row=1))
    # Relocalization from keyframe matches runs LightGlue at B=3.
    q, k, v, mask = attention_inputs(g, 3, NK, dev)
    mask[2] = False
    attn_err = max(attn_err, _attention_case(fa, f"B=3 N={NK}", q, k, v, mask, masked_row=2))
    # Strided views: q, k, v cut from one packed [B, N, 3, H, Dh] tensor.
    x = torch.randn(2, 1000, 3, 4, 64, generator=g).to(dev, torch.bfloat16)
    mask = (torch.rand(2, 1000, generator=g) > 0.2).to(dev)
    attn_err = max(attn_err, _attention_case(
        fa, "strided views B=2 N=1000", x[:, :, 0], x[:, :, 1], x[:, :, 2], mask))
    for dtype in (torch.bfloat16, torch.float32):
        attn_err = max(attn_err, _attention_grad_case(fa, g, dev, dtype))

    nn_err = 0.0
    # Path A's SuperPoint size, path B's synthetic size, ragged ones (N1 not
    # a multiple of the split width).
    # ... and relocalization's global match against the landmark table, in
    # both directions (at 16384 rows one column split: the merge runs S=1).
    for (N0, N1, Dd) in ((NK, NK, D), (512, 512, 64), (200, 180, 64), (NK, 1000, D),
                         (300, 130, 64), (NK, RELOC_L, D), (RELOC_L, NK, D)):
        d0, v0, d1, v1 = nn_inputs(g, N0, N1, Dd, dev)
        nn_err = max(nn_err, _nn_case(nm, f"{N0}x{N1}x{Dd}", d0, d1, v1))
        m, _ = nm.mutual_nn_match(d0, v0, d1, v1, ratio=0.8)
        m_p, _ = nm.mutual_gate(nm.nn_reduce_plain(d0, d1, v1),
                                nm.nn_reduce_plain(d1, d0, v0), v0, v1, ratio=0.8)
        agree = float((m == m_p).float().mean())
        log(f"# parity mutual nn {N0}x{N1}x{Dd}: matches agree {agree:.4f}")
        if not agree > 0.99:
            raise AssertionError(f"mutual nn {N0}x{N1}x{Dd} disagrees with plain")
    # Exact duplicate columns, in one 64-column tile and across column splits;
    # rows 0-2 are copies of the duplicated columns, so each row's best is a tie.
    d0, _, d1, v1 = nn_inputs(g, NK, 1000, D, dev)
    v1[:] = True
    ties = []
    for r, (lo, hi) in enumerate(((3, 40), (5, 900), (130, 131))):
        d1[hi] = d1[lo]
        d0[r] = d1[lo]
        ties.append((r, lo, hi))
    nn_err = max(nn_err, _nn_case(nm, "duplicate columns 1024x1000x256", d0, d1, v1,
                                  ties=ties))
    # Every column invalid: best = second = 1e9 at index 0.
    v1[:] = False
    _nn_case(nm, "all columns invalid 1024x1000x256", d0, d1, v1)
    best, idx, second = nm.nn_reduce(d0, d1, v1)
    if not (bool((idx == 0).all()) and bool((best == nm.BIG).all())
            and bool((second == nm.BIG).all())):
        raise AssertionError("nn matcher: all-invalid columns")
    return attn_err, nn_err


def _matched_agreement(m_a, m_b) -> float:
    """Share of the keypoints matched by either side whose matches0 agree."""
    either = (m_a >= 0) | (m_b >= 0)
    return float((m_a == m_b)[either].float().mean()) if bool(either.any()) else 1.0


def phase_lightglue(scene, pairs=((0, 3), (20, 23), (40, 43))):
    """Path A frame pairs through LightGlueMatcher at full width: with the
    kernel, with masked_attention_f32p (the kernel's precision) and with
    masked_attention_plain (P rounded to bf16 once) swapped in."""
    from rover_slam_tpu_torch.models import lightglue as lgm
    from rover_slam_tpu_torch.ops import flash_attention as fa
    lg = scene.matcher.matcher
    saved = snapshot_counters()
    results = []
    for i0, i1 in pairs:
        f0, f1 = scene.ext(scene.imgs[i0]), scene.ext(scene.imgs[i1])
        args = (lgm.normalize_keypoints(f0["keypoints"], (H, W)), f0["descriptors"],
                f0["valid"], lgm.normalize_keypoints(f1["keypoints"], (H, W)),
                f1["descriptors"], f1["valid"])
        both = (args[2][:, :, None] & args[5][:, None, :])[0]
        la, m = {}, {}
        with torch.no_grad():
            for name, fn in (("kernel", fa.masked_attention), ("f32p", masked_attention_f32p),
                             ("plain", fa.masked_attention_plain)):
                n0 = counter("attention_launches")
                lgm.masked_attention = fn
                try:
                    full = lg.model(*args)[0]
                finally:
                    lgm.masked_attention = fa.masked_attention
                la[name] = full[0, :-1, :-1]
                m[name] = lgm.extract_matches(full, args[2], args[5],
                                              lg.threshold)["matches0"][0]
                if name == "kernel" and counter("attention_launches") - n0 != 4 * LIGHTGLUE_LAYERS:
                    raise AssertionError("LightGlue did not run every attention call "
                                         "on the kernel")
        res = {"pair": [i0, i1]}
        for name in ("f32p", "plain"):
            d = (la["kernel"] - la[name]).abs()[both]
            res[name] = {"matched_agree": _matched_agreement(m["kernel"], m[name]),
                         "all_agree": float((m["kernel"] == m[name]).float().mean()),
                         "log_assignment_max_abs_err": float(d.max()),
                         "assignment_prob_max_abs_err": float(
                             (la["kernel"].exp() - la[name].exp()).abs()[both].max())}
        res["plain_vs_f32p_matched_agree"] = _matched_agreement(m["plain"], m["f32p"])
        res["matches"] = {k: int((v >= 0).sum()) for k, v in m.items()}
        log("# lightglue kernel vs plain attentions:", json.dumps(res))
        results.append(res)
    reset_counters(saved)
    for res in results:
        for name, key, limit in (("f32p", "matched_agree", LIGHTGLUE_AGREE),
                                 ("plain", "matched_agree", LIGHTGLUE_AGREE_REF),
                                 ("plain", "all_agree", LIGHTGLUE_AGREE_ALL)):
            if not res[name][key] >= limit:
                raise AssertionError(f"LightGlue pair {res['pair']}: kernel against the "
                                     f"{name} attention, {key} {res[name][key]:.4f} "
                                     f"< {limit}")
    return results


def phase_timing(dev):
    """Each kernel at the main path's shapes, beside its bound, its plain
    version and one library call for the same function, all timed by
    cuda_time_ms on the same inputs. B1's row times the wrapper, the call the
    path makes (its one elementwise division of q by sqrt(Dh), then the
    launch); the launch alone on a q already divided is logged beside it."""
    from rover_slam_tpu_torch.ops import flash_attention as fa, nn_matcher as nm
    g = torch.Generator().manual_seed(1)
    rows = {}
    saved = snapshot_counters()
    for B in (1, 2, 3):
        q, k, v, mask = attention_inputs(g, B, NK, dev)
        qs = fa._scale_q(q)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        amask = mask[:, None, None, :]
        t = cuda_time_ms(lambda: fa.masked_attention(q, k, v, mask))
        t_launch = cuda_time_ms(lambda: fa._launch(qs, k, v, mask))
        tp = cuda_time_ms(lambda: fa.masked_attention_plain(q, k, v, mask))
        tl = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask))
        Hh, Dh = q.shape[2], q.shape[3]
        n_bytes = 4 * B * NK * Hh * Dh * 2 + B * NK
        n_flops = 4.0 * B * Hh * NK * NK * Dh
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"# timing attention B={B} N={NK} H={Hh} Dh={Dh}: wrapper {t:.4f} ms "
            f"(launch alone {t_launch:.4f}), plain {tp:.4f} ms, sdpa {tl:.4f} ms, "
            f"bound {bnd:.5f} ms ({by})")
        rows[f"attention_B{B}"] = (t, tp, tl, bnd, by)
    for (N0, N1, Dd) in ((512, 512, 64), (NK, NK, D), (NK, RELOC_L, D)):
        d0, _, d1, v1 = nn_inputs(g, N0, N1, Dd, dev)
        b0, b1 = d0.to(torch.bfloat16), d1.to(torch.bfloat16)
        t = cuda_time_ms(lambda: nm.nn_reduce(b0, b1, v1))
        tp = cuda_time_ms(lambda: nm.nn_reduce_plain(b0, b1, v1))
        tl = cuda_time_ms(lambda: torch.cdist(d0, d1).topk(2, dim=1, largest=False))
        n_bytes = (N0 + N1) * Dd * 2 + N1 + 3 * N0 * 4
        n_flops = 2.0 * N0 * N1 * Dd
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"# timing nn {N0}x{N1}x{Dd}: kernel {t:.4f} ms "
            f"({-(-N1 // nm._split_cols(N0, N1))} column splits), plain {tp:.4f} ms, "
            f"cdist+topk {tl:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows[f"nn_{N0}x{N1}x{Dd}"] = (t, tp, tl, bnd, by)
    rows.update(_pose_opt_timing(g, dev))
    reset_counters(saved)
    log("# timing rows (ms, plain_ms, library_ms, bound_ms, bound_by[, pose error]):",
        json.dumps(rows))
    return rows


def pose_opt_inputs(g, M, dev):
    """A tracker-sized pose problem: M landmarks 1.5-12 m in front of path
    A's camera, observed with 0.3 px of noise, 10 % outliers, the start pose
    ~0.02 rad and ~3 cm off."""
    from rover_slam_tpu_torch.geometry import cameras, lie
    cam = torch.tensor([FX, FX, W / 2.0, H / 2.0, 0, 0, 0, 0], dtype=torch.float32)
    u = torch.rand(M, generator=g) * (W - 40) + 20
    v = torch.rand(M, generator=g) * (H - 40) + 20
    z = torch.rand(M, generator=g) * 10.5 + 1.5
    Xc = torch.stack([(u - W / 2.0) / FX * z, (v - H / 2.0) / FX * z, z], -1)
    uv = cameras.project(cameras.PINHOLE, cam, Xc) + 0.3 * torch.randn(M, 2, generator=g)
    uv[torch.rand(M, generator=g) < 0.1] += 30.0
    R0 = lie.so3_exp(0.02 * torch.randn(3, generator=g))
    t0 = 0.03 * torch.randn(3, generator=g)
    kw = dict(R_cw=R0, t_cw=t0, Xw=Xc, uv=uv, valid=torch.rand(M, generator=g) > 0.1,
              cam_params=cam)
    return {k: x.to(dev).contiguous() for k, x in kw.items()}


def _pose_opt_timing(g, dev, M: int = 1024):
    """pose_opt at the tracker's two calls a frame. Operations: ~300 f32
    flops an edge an iteration (residual, Jacobian, 27 sums); bytes: the
    edges read once, the outputs written once."""
    from rover_slam_tpu_torch.optim import pose_opt as po
    kw = pose_opt_inputs(g, M, dev)
    rows = {}
    for rounds, iters in ((2, 5), (2, 6)):
        sched = dict(rounds=rounds, iters_per_round=iters, check_cost=False)
        t = cuda_time_ms(lambda: po.pose_optimization(**kw, **sched))
        tp = eager_time_ms(lambda: po.pose_optimization_plain(**kw, **sched))
        out = po.pose_optimization(**kw, **sched)
        ref = po.pose_optimization_plain(**kw, **sched)
        err = max(float((out.R_cw - ref.R_cw).abs().max()),
                  float((out.t_cw - ref.t_cw).abs().max()))
        n_bytes = M * (12 + 8 + 1) + 48 + M * (1 + 4) + 56
        n_flops = 300.0 * M * rounds * iters
        bnd, by = bound_ms(n_bytes, n_flops, PEAK_F32_FLOPS)
        log(f"# timing pose_opt M={M} {rounds}x{iters}: kernel {t:.4f} ms, plain "
            f"{tp:.4f} ms (eager), pose error {err:.3g} (inliers {int(out.n_inliers)} / "
            f"{int(ref.n_inliers)}), bound {bnd:.6f} ms ({by}, f32)")
        if not err < 1e-4:
            raise AssertionError(f"pose_opt {rounds}x{iters} disagrees with plain: {err}")
        rows[f"pose_opt_{rounds}x{iters}"] = (t, tp, None, bnd, by, err)
    return rows


# ---------------------------------------------------------------------------
def run_path_a(scene):
    """Every frame of the scene through a fresh synchronous system; the
    result line, with the kernel launches counted from 0 over the run."""
    from rover_slam_tpu_torch.slam import tracking as T

    n_frames = len(scene.imgs)
    scene.warm_up()
    slam = scene.new_slam()
    R_gt, t_gt, times = scene.R_gt, scene.t_gt, scene.times

    _reset_launches()
    frame_ms, states = [], []
    t0 = time.perf_counter()
    for i in range(n_frames):
        t1 = time.perf_counter()
        states.append(scene.step(slam, i)["state"])
        frame_ms.append((time.perf_counter() - t1) * 1000.0)
    wall = time.perf_counter() - t0
    launches = _launches()
    frame_ms = np.asarray(frame_ms)
    n_tracked = sum(s == T.OK for s in states)
    ate_cm, pairs = _ate_cm(slam, R_gt, t_gt, times)
    n_lm = int(slam.state.n_lm)
    res = {"frames": n_frames, "fps": n_frames / wall,
           "frame_ms_median": float(np.median(frame_ms)),
           "frame_ms_p95": float(np.percentile(frame_ms, 95)),
           "frame_ms_max": float(frame_ms.max()),
           "ate_cm": ate_cm, "frac_tracked": n_tracked / n_frames,
           "frames_tracked": n_tracked,
           "n_kf": slam.n_kf, "n_lm": n_lm, "launches": launches,
           "trajectory_digest": trajectory_digest(slam),
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()}}
    log("# path A:", json.dumps(res))
    return res


def phase_path_a(scene):
    res = run_path_a(scene)
    launches, n_tracked = res["launches"], res["frames_tracked"]
    if not res["frac_tracked"] >= 0.9:
        raise AssertionError(f"path A tracked only {res['frac_tracked']:.2f} of frames")
    if not launches["attention"] >= 36 * n_tracked:
        raise AssertionError(f"path A: {launches['attention']} attention launches "
                             f"for {n_tracked} tracked frames")
    if not res["n_lm"] < scene.L - (3 * NK + 64):
        raise AssertionError(f"path A: n_lm {res['n_lm']} reached the compaction threshold")
    if not math.isfinite(res["ate_cm"]):
        raise AssertionError("path A: trajectory not finite")
    return res


def _path_b_frames(n_frames, seed=0):
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=seed)
    gt = synthetic.forward_trajectory(n_frames=n_frames, dt=0.1, speed=0.6, yaw_rate=0.04)
    frames = synthetic.render_sequence(world, *gt, n_kpts=512, pix_noise=0.4,
                                       desc_noise=0.05)
    return world, frames, gt


def _feed(slam, frames, t_shift=0.0):
    return [slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time + t_shift)["state"]
            for f in frames]


def phase_path_b(dev):
    """The package default (matcher=None -> mutual-NN on kernel B2) on the
    synthetic oracle world of tests/test_e2e_mono.py."""
    from rover_slam_tpu_torch.slam import tracking as T
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    world, frames, (R_gt, t_gt, times) = _path_b_frames(40)
    slam = MonocularSLAM(world.cam_params, map_capacity=(64, 512, 8192), desc_dim=64,
                         device=dev)
    _reset_launches()
    t0 = time.perf_counter()
    states = _feed(slam, frames)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _launches()
    ate_cm, _ = _ate_cm(slam, R_gt, t_gt, times)
    first_ok = states.index(T.OK) if T.OK in states else len(states)
    res = {"frames": len(frames), "fps": len(frames) / wall, "ate_cm": ate_cm,
           "all_ok_after_init": all(s == T.OK for s in states[first_ok:]),
           "n_kf": slam.n_kf, "n_lm": int(slam.state.n_lm), "launches": launches}
    log("# path B:", json.dumps(res))
    if not (slam.tracking_state == T.OK and res["all_ok_after_init"]):
        raise AssertionError("path B: tracking not OK after init")
    if not ate_cm < 3.0:
        raise AssertionError(f"path B: ATE {ate_cm:.3f} cm >= 3 cm")
    if not launches["nn"] > 0:
        raise AssertionError("path B: the NN kernel was never launched")
    return res


def garbage_frame(rng, t, n_kpts=512, dim=64):
    """Random keypoints and descriptors: a frame no map can match."""
    from types import SimpleNamespace
    kpts = rng.uniform(20, 400, (n_kpts, 2)).astype(np.float32)
    desc = rng.normal(size=(n_kpts, dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    rays = np.concatenate([kpts * 0.001, np.ones((n_kpts, 1))], 1).astype(np.float32)
    return SimpleNamespace(kpts=kpts, rays=rays, desc=desc, valid=np.ones(n_kpts, bool),
                           time=t)


def phase_path_b_kidnap(dev):
    """tests/test_e2e_mono.py's kidnapped robot on path B's world: 20 frames,
    4 unmatchable ones, then frame 10's view again. Tracking must go
    RECENTLY_LOST, attempt the global relocalization (B2 at 512 x 8192 x 64
    against the landmark table, both directions) on the lost frames, and
    come back OK at frame 10's logged position within 5 cm (as in the JAX
    package, the returning view is recovered by the tracker's reference
    keyframe match before a relocalization is due)."""
    from rover_slam_tpu_torch.slam import tracking as T
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    world, frames, _ = _path_b_frames(30)
    slam = MonocularSLAM(world.cam_params, map_capacity=(64, 512, 8192), desc_dim=64,
                         device=dev)
    _reset_launches()
    _feed(slam, frames[:20])
    rng = np.random.default_rng(99)
    lost = _feed(slam, [garbage_frame(rng, 2.0 + 0.1 * k) for k in range(4)])
    nn_before = _launches()["nn"]
    f = frames[10]
    info = slam.track_frame(f.kpts, f.rays, f.desc, f.valid, 3.0)
    _sync(dev)
    launches = _launches()
    entry = next(e for e in slam.trajectory if abs(e[0] - f.time) < 1e-6)
    R10, t10 = (x.cpu().numpy() for x in entry[1:3])
    R, t = (x.cpu().numpy() for x in info["pose"])
    dist = float(np.linalg.norm(-R.T @ t + R10.T @ t10))
    res = {"states_lost": lost, "state": info["state"], "reloc_attempts": slam.reloc_attempts,
           "reloc_successes": slam.reloc_successes, "dist_to_frame10": dist,
           "nn_reduces_last_frame": launches["nn"] - nn_before, "launches": launches}
    log("# path B kidnap:", json.dumps(res))
    if not (lost[-1] == T.RECENTLY_LOST and info["state"] == T.OK
            and slam.reloc_attempts >= 1 and dist < 0.05):
        raise AssertionError("path B kidnap: not back at frame 10's pose")
    return res


def phase_path_b_lifecycle(dev):
    """Slot recycling (tests/test_torch_system_compaction.py's scene): the
    lifecycle tests' tracker settings (cull every 3 keyframes, a keyframe at
    least every 4 frames) on tables of 16 keyframes and 2048 landmarks, 64
    frames of path B's world. The tables must be compacted at least twice,
    more keyframes created than the table holds, no landmark dropped, and
    tracking OK after init."""
    from rover_slam_tpu_torch.slam import tracking as T
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    world, frames, (R_gt, t_gt, times) = _path_b_frames(64)
    cfg = T.TrackerConfig(kf_cull_every=3, kf_max_interval=4, min_init_matches=50,
                          min_inliers_local_map=12)
    K = 16
    slam = MonocularSLAM(world.cam_params, config=cfg, map_capacity=(K, 512, 2048),
                         desc_dim=64, device=dev)
    _reset_launches()
    states = _feed(slam, frames)
    ate_cm, _ = _ate_cm(slam, R_gt, t_gt, times)
    first_ok = states.index(T.OK) if T.OK in states else len(states)
    res = {"compactions": slam.compactions, "keyframes_created": slam._next_uid,
           "n_kf": slam.n_kf, "culled_redirects": len(slam._kf_redirect),
           "lm_dropped": int(slam.state.lm_dropped), "n_lm": int(slam.state.n_lm),
           "all_ok_after_init": all(s == T.OK for s in states[first_ok:]),
           "ate_cm": ate_cm, "launches": _launches()}
    log("# path B lifecycle:", json.dumps(res))
    if not (res["compactions"] >= 2 and res["lm_dropped"] == 0 and res["all_ok_after_init"]
            and slam._next_uid > K and math.isfinite(ate_cm)):
        raise AssertionError("path B lifecycle: tables not recycled cleanly")
    return res


def phase_path_c(scene):
    """Path C once (path E runs the same tracker twice and holds the two
    runs to one digest)."""
    r = run_path_c(scene, count_syncs=True)
    if not r["frac_tracked"] >= 0.9:
        raise AssertionError(f"path C tracked only {r['frac_tracked']:.2f} of frames")
    if not r["launches"]["attention"] >= 36 * r["frames_tracked"]:
        raise AssertionError(f"path C: {r['launches']['attention']} attention launches "
                             f"for {r['frames_tracked']} tracked frames")
    if not math.isfinite(r["ate_cm"]):
        raise AssertionError("path C: trajectory not finite")
    return r


def phase_path_e(scene):
    """Path E twice (bench.py's configuration): one digest, >= 90 % of
    frames tracked, a loop fired in each run. Run 1 keeps its system for
    path M."""
    runs = [run_path_c(scene, count_syncs=True, loop=True, name="E", keep_slam=True),
            run_path_c(scene, count_syncs=False, loop=True, name="E")]
    for r in runs:
        if not r["frac_tracked"] >= 0.9:
            raise AssertionError(f"path E tracked only {r['frac_tracked']:.2f} of frames")
        if not r["n_loops"] >= 1:
            raise AssertionError(f"path E: no loop fired ({r['loop_diag']})")
        if not math.isfinite(r["ate_cm"]):
            raise AssertionError("path E: trajectory not finite")
    if runs[0]["trajectory_digest"] != runs[1]["trajectory_digest"]:
        raise AssertionError("path E: two runs gave different trajectories")
    return runs


def phase_path_m(scene, e_run1, dev):
    """Path M: the profiling twins' stage functions on path E run 1's final
    map, one pass (warm-up 1, reps 1): profile_stages_port.program_stages
    and profile_insert_port.insert_stages. Gates: every stage time finite
    and positive, insert_full(ba2) adds one keyframe, triangulate_x2
    launches B2, match_batch launches B1 at B = n_candidates, and each
    stage's output digest equal over its two untimed calls on fresh
    clones."""
    from profile_insert_port import insert_stages
    from profile_stages_port import program_stages
    t_m = time.perf_counter()
    slam = e_run1.pop("_slam")
    n_kf, B = slam.n_kf, slam.loop_closer.cfg.n_candidates
    _reset_launches()
    lines = []

    def emit(*a):
        lines.append(" ".join(str(x) for x in a))
    stages = program_stages(slam, scene.matcher, dev, warmup=1, reps=1, fused_reps=1,
                            emit=emit)
    insert = insert_stages(slam.state, scene.cam, warmup=1, reps=1, emit=emit)
    _sync(dev)
    launches = _launches()
    del slam
    for ln in lines:
        log("# path M:", ln)
    timed = {**stages, **{k: r for k, r in insert.items() if k != "state_copy_ms"}}
    res = {"stages": {k: {f: r[f] for f in ("ms", "b1", "b2", "syncs", "b1_by_batch")}
                      for k, r in timed.items()},
           "candidates": stages["detect_add_ms"]["candidates"], "n_kf": n_kf,
           "launches": {k: launches[k] for k in ("attention", "nn", "pose_opt")},
           "s": time.perf_counter() - t_m, "card": card()}
    log("# path M:", json.dumps(res))
    bad = [k for k, r in timed.items() if not (math.isfinite(r["ms"]) and r["ms"] > 0)]
    if bad:
        raise AssertionError(f"path M: stage times not finite and positive: "
                             f"{ {k: timed[k]['ms'] for k in bad} }")
    scal = insert["insert_full(ba2)_ms"]["out"][0]
    if int(scal[4]) != n_kf + 1:
        raise AssertionError(f"path M: insert_full(ba2) gave n_kf {int(scal[4])}, not {n_kf + 1}")
    if not insert["triangulate_x2_ms"]["b2"] >= 2:
        raise AssertionError(f"path M: triangulate_x2 launched B2 "
                             f"{insert['triangulate_x2_ms']['b2']} times")
    mb = stages[f"match_batch{B}_ms"]["b1_by_batch"]
    if not mb.get(B, 0) > 0:
        raise AssertionError(f"path M: match_batch launched B1 at {mb}, not at B={B}")
    split = [k for k, r in timed.items() if len(set(r["digests"])) != 1]
    if split:
        raise AssertionError(f"path M: outputs differ between calls on fresh clones: {split}")
    return res


# ---------------------------------------------------------------------------
# Path L: the distributed back end (parallel/sharded_ba.py, multihost.py).
L_SHARDS = 8              # shards of the in-process mesh (L1, L2, L4)
L_DT_BOUND = 5e-3         # active keyframes' |dt| against the single solve (tests/test_sharded_ba.py)
L_ATE_BOUND_CM = 50.0     # L2, as path H's bound
L_TRACKED_MIN = 0.9
# L3's gloo run (two processes of 4 shards) against L1's 8 in-process
# shards: the same solve, summed in another order (4 + 4 shards, then the
# all_reduce), which LM carries along as the CPU test measures
# (tests/test_torch_sharded_ba.py: poses within 5e-5, costs within 2.7e-5
# relative at 10 iterations). Held here to L_DT_BOUND on active keyframes
# and to L3_COST_RTOL on every cost of the history.
L3_COST_RTOL = 1e-3
L3_TIMEOUT_S = 300


def _timed(fn, dev):
    """(result, ms) of fn() between two device synchronizes."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1000.0


def _peak_bytes(dev, reset: bool = False):
    """torch.cuda's peak allocation since the last reset (None on the CPU,
    where the CPU rehearsal of path L runs)."""
    if dev.type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated()


def initial_cost(prob) -> float:
    """The robust cost of a BA problem at its initial variables: the first
    entry of the JAX package's solve_ba cost history."""
    from rover_slam_tpu_torch.geometry import cameras
    from rover_slam_tpu_torch.optim import ba, robust
    e, _, _, _ = ba._edge_terms(cameras.PINHOLE, prob, prob.R_cw, prob.t_cw, prob.lm_pos)
    chi2 = torch.sum(e * e, dim=-1) * prob.e_info
    return float(torch.sum(robust.huber_cost(chi2, robust.CHI2_MONO) * prob.e_valid.float()))


def _solve_outputs(out) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in zip(("R", "t", "X", "costs"), out)}


def run_path_l1(slam, dev) -> tuple:
    """L1 on the map path L2 ends with: its global problem (the whole padded
    table) through solve_ba(pcg, phases=1), solve_ba_sharded (twice: the
    second run must give the same bits) and solve_ba_sharded_lm (once: its
    second run is L3's NCCL process, held to it to the bit; one run takes
    ~30 s on the card). Returns (result line, the problem, the sharded
    outputs)."""
    from rover_slam_tpu_torch.map import maintenance
    from rover_slam_tpu_torch.optim import ba
    from rover_slam_tpu_torch.parallel import sharded_ba
    mesh = sharded_ba.make_mesh(L_SHARDS, device=dev)
    prob, _ = maintenance._build_global_problem(slam.state, slam.cam_params)
    kw = dict(iters=10, cg_iters=25)
    cost0 = initial_cost(prob)
    _peak_bytes(dev, reset=True)
    single, ms_single = _timed(lambda: ba.solve_ba(prob, solver="pcg", phases=1, **kw), dev)
    mem_single = _peak_bytes(dev)
    part = sharded_ba.partition_by_landmark(prob, mesh.size)
    res = {"table_rows": int(prob.e_kf.shape[0]), "live_edges": int(prob.e_valid.sum()),
           "keyframes": int(prob.pose_opt_mask.sum()), "landmarks": int(prob.lm_opt_mask.sum()),
           "Ls": -(-prob.lm_pos.shape[0] // mesh.size),
           "Es": int(part[0].e_kf.shape[0]) // mesh.size,
           "padded_rows_lm": int(part[0].e_kf.shape[0]),
           "padded_rows_edges": -(-prob.e_kf.shape[0] // mesh.size) * mesh.size,
           "cost_initial": cost0, "single_ms": ms_single, "single_peak_bytes": mem_single}
    del part
    act = slam.state.kf_active.cpu().numpy()
    t_single = single.t_cw.cpu().numpy()
    outs = {}
    for name, solve in (("edges", sharded_ba.solve_ba_sharded),
                        ("landmarks", sharded_ba.solve_ba_sharded_lm)):
        _peak_bytes(dev, reset=True)
        a, ms_a = _timed(lambda: solve(prob, mesh, **kw), dev)
        peak = _peak_bytes(dev)
        o = _solve_outputs(a)
        outs[name] = o
        res[name] = {"ms": [ms_a], "peak_bytes": peak,
                     "cost_first": float(o["costs"][0]), "cost_final": float(o["costs"][-1]),
                     "max_dt_vs_single": float(np.abs(o["t"] - t_single)[act].max())}
        if name == "edges":
            b, ms_b = _timed(lambda: solve(prob, mesh, **kw), dev)
            res[name]["ms"].append(ms_b)
            res[name]["repeat_equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
    log("# path L1:", json.dumps(res))
    for name in ("edges", "landmarks"):
        r = res[name]
        if not (r["cost_final"] < cost0 and r["max_dt_vs_single"] < L_DT_BOUND
                and r.get("repeat_equal", True)):
            raise AssertionError(f"path L1 {name}: {r} (initial cost {cost0})")
    return res, prob, outs


def l3_worker(pid: int, nproc: int, port: int, backend: str, n_local: int, device: str,
              src: str, out: str):
    """One process of L3: joins the group, solves the npz's problem with
    solve_ba_multihost (edge-sharded, then landmark-sharded) on n_local
    shards of `device`, and (process 0) writes the outputs."""
    import torch.distributed as dist
    from rover_slam_tpu_torch.optim import ba
    from rover_slam_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, backend=backend)
    try:
        with np.load(src) as z:
            prob = ba.BAProblem(**{k: torch.from_numpy(z[k]) for k in z.files})
        mesh = multihost.global_mesh(n_local, device=dev)
        res = {"mesh_size": mesh.size}
        for name, lm in (("edges", False), ("landmarks", True)):
            o, ms = _timed(lambda: multihost.solve_ba_multihost(prob, mesh, lm_sharded=lm,
                                                                iters=10, cg_iters=25), dev)
            res.update({f"{name}_{k}": v for k, v in _solve_outputs(o).items()})
            res[f"{name}_ms"] = ms
        if pid == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_workers(tmp: str, prob_npz: str, backend: str, nproc: int, n_local: int,
                   device: str):
    """nproc spawned l3_worker processes on one process group; returns
    (processes, process 0's output file)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = os.path.join(tmp, f"l3_{backend}_{nproc}.npz")
    port = _free_port()
    procs = [ctx.Process(target=l3_worker, args=(pid, nproc, port, backend, n_local, device,
                                                 prob_npz, out)) for pid in range(nproc)]
    for p in procs:
        p.start()
    return procs, out


def _join_workers(runs: dict) -> dict:
    """Join every worker with one deadline (L3_TIMEOUT_S), kill any still
    running on expiry, and read process 0's outputs of each run."""
    t0 = time.perf_counter()
    procs = [p for ps, _ in runs.values() for p in ps]
    try:
        for p in procs:
            p.join(timeout=max(1.0, L3_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = {name: [p.exitcode for p in ps] for name, (ps, _) in runs.items()}
    if any(c != 0 for cs in codes.values() for c in cs):
        raise AssertionError(f"path L3: worker exit codes {codes}")
    res = {}
    for name, (_, out) in runs.items():
        with np.load(out) as z:
            res[name] = {k: z[k] for k in z.files}
    return res


def run_path_l3(prob, l1_outs, act, device: str) -> dict:
    """L3: L1's problem to an npz; two gloo processes of 4 shards on the
    card, held to L1's 8-shard results within L_DT_BOUND and L3_COST_RTOL,
    and at the same time one NCCL process of 8 shards, held to them to the
    bit. The three processes share the card, so their solve times are not
    the solver's alone."""
    res = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="path_l3_") as tmp:
        src = os.path.join(tmp, "problem.npz")
        np.savez(src, **{k: v.cpu().numpy() for k, v in prob._asdict().items()
                         if isinstance(v, torch.Tensor)})
        runs = _join_workers({
            "gloo 2x4": _start_workers(tmp, src, "gloo", 2, L_SHARDS // 2, device),
            "nccl 1x8": _start_workers(tmp, src, "nccl", 1, L_SHARDS, device)})
    res["s"] = time.perf_counter() - t0
    for run, r in runs.items():
        res[run] = {"mesh_size": int(r["mesh_size"])}
        for name in ("edges", "landmarks"):
            ref = l1_outs[name]
            got = {k: r[f"{name}_{k}"] for k in ("R", "t", "X", "costs")}
            res[run][name] = {
                "ms": float(r[f"{name}_ms"]),
                "max_dt": float(np.abs(got["t"] - ref["t"])[act].max()),
                "max_cost_rel": float(np.max(np.abs(got["costs"] - ref["costs"])
                                             / np.abs(ref["costs"]))),
                "bit_equal": all(np.array_equal(got[k], ref[k]) for k in got)}
    log("# path L3:", json.dumps(res))
    for name in ("edges", "landmarks"):
        g = res["gloo 2x4"][name]
        if not (g["max_dt"] < L_DT_BOUND and g["max_cost_rel"] < L3_COST_RTOL):
            raise AssertionError(f"path L3 gloo {name}: {g}")
        if not res["nccl 1x8"][name]["bit_equal"]:
            raise AssertionError(f"path L3 nccl {name}: {res['nccl 1x8'][name]}")
    return res


def phase_path_l(scene, e_run1, dev):
    """Path L (A17, the distributed back end). L2: path E's run once more
    with MonocularSLAM(mesh=make_mesh(L_SHARDS)): the loop event of path E
    run 1, every pose logged before it equal to run 1's to the bit, >=
    L_TRACKED_MIN tracked, ATE under L_ATE_BOUND_CM. L1: map-scale solver
    parity on L2's final map (run_path_l1). L3: two processes over gloo and
    one over NCCL (run_path_l3). L4: entry.dryrun_multichip(L_SHARDS) and
    entry()'s front-end step once."""
    from rover_slam_tpu_torch import entry
    from rover_slam_tpu_torch.parallel import sharded_ba
    t_l = time.perf_counter()
    _peak_bytes(dev, reset=True)
    l2 = run_path_c(scene, count_syncs=False, loop=True, name="L2",
                    mesh=sharded_ba.make_mesh(L_SHARDS, device=dev), keep_slam=True)
    l2["peak_bytes"] = _peak_bytes(dev)
    slam = l2.pop("_slam")
    ev, ev_e = l2["loop_events"], e_run1["loop_events"]
    keys = ("kf", "query_kf", "candidate", "n_inliers", "scale")
    same_loop = bool(ev) and bool(ev_e) and all(ev[0][k] == ev_e[0][k] for k in keys)
    a, b = l2.pop("_poses_before_fire"), e_run1["_poses_before_fire"]
    poses_equal = len(a) == len(b) and all(
        x[0] == y[0] and x[1] == y[1] and np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])
        for x, y in zip(a, b))
    check = {"same_loop": same_loop, "poses_before_fire": len(a),
             "poses_before_fire_equal": poses_equal, "peak_bytes": l2["peak_bytes"],
             "fire_frame": l2["fire_frame"], "fire_frame_e": e_run1["fire_frame"]}
    log("# path L2 checks:", json.dumps(check))
    if not (same_loop and poses_equal and len(a) > 0):
        raise AssertionError(f"path L2: {check}; loops {ev[:1]} vs path E {ev_e[:1]}")
    if not (l2["frac_tracked"] >= L_TRACKED_MIN and l2["ate_cm"] < L_ATE_BOUND_CM):
        raise AssertionError(f"path L2 tracked {l2['frac_tracked']:.2f}, ATE {l2['ate_cm']}")
    l1, prob, outs = run_path_l1(slam, dev)
    act = slam.state.kf_active.cpu().numpy()
    del slam
    l3 = run_path_l3(prob, outs, act, str(dev))
    del prob

    _reset_launches()
    dry, ms_dry = _timed(lambda: entry.dryrun_multichip(L_SHARDS, device=dev), dev)
    fn, args = entry.entry(device=dev)
    (m, sc, kp), ms_fn = _timed(lambda: fn(*args), dev)
    l4 = {"dryrun_ms": ms_dry, "entry_ms": ms_fn, "dryrun_costs": dry["edges"][3].tolist(),
          "entry_shapes": [list(m.shape), list(kp.shape)], "launches": _launches()}
    log("# path L4:", json.dumps(l4))
    if not (m.shape == (1, entry.ENTRY_KPTS) and bool(torch.isfinite(sc).all())
            and bool(torch.isfinite(kp).all())):
        raise AssertionError(f"path L4: {l4}")
    launches = {k: l2["launches"][k] + l4["launches"][k]
                for k in ("attention", "nn", "pose_opt")}
    res = {"L1": l1, "L2": l2, "L2_checks": check, "L3": l3, "L4": l4, "launches": launches,
           "s": time.perf_counter() - t_l, "card": card()}
    log(f"# path L: {res['s']:.1f} s, launches {json.dumps(launches)}")
    return res


def _ring_frames(n_frames, revs, seed=0):
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.ring_world(n_landmarks=6000, desc_dim=64, seed=seed)
    gt = synthetic.orbit_trajectory(n_frames=n_frames, revs=revs)
    frames = synthetic.render_sequence(world, *gt, n_kpts=512, pix_noise=0.5,
                                       desc_noise=0.05)
    return world, frames, gt


def run_path_f(dev, pipeline: int):
    """tests/test_loop_closing_e2e.py's loop run on the card."""
    from rover_slam_tpu_torch.slam import tracking as T
    from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    world, frames, (R_gt, t_gt, times) = _ring_frames(100, 1.25)
    slam = MonocularSLAM(world.cam_params, map_capacity=(128, 512, 16384), desc_dim=64,
                         enable_loop_closing=True, config=T.TrackerConfig(local_map_only=True),
                         loop_config=LoopConfig(min_covis_weight=20), pipeline=pipeline,
                         device=dev)
    _reset_launches()
    t0 = time.perf_counter()
    _feed(slam, frames)
    slam.flush()
    _sync(dev)
    wall = time.perf_counter() - t0
    ate_cm, _ = _ate_cm(slam, R_gt, t_gt, times)
    res = {"pipeline": pipeline, "frames": len(frames), "fps": len(frames) / wall,
           "ate_cm": ate_cm, "state": slam.tracking_state, "n_kf": slam.n_kf,
           "launches": _launches(), **loop_summary(slam),
           "place_recog_median_ms": slam.timers.summary().get(
               "place_recog", {}).get("median_ms")}
    log(f"# path F (pipeline={pipeline}):", json.dumps(res))
    ev = res["loop_events"]
    if not (slam.tracking_state == T.OK and ev):
        raise AssertionError(f"path F (pipeline={pipeline}): no loop fired")
    if not (ev[0]["candidate"] < ev[0]["kf"] - 10 and 0.5 < ev[0]["scale"] < 2.0):
        raise AssertionError(f"path F (pipeline={pipeline}): implausible loop {ev[0]}")
    if not ate_cm < 5.0:
        raise AssertionError(f"path F (pipeline={pipeline}): ATE {ate_cm:.2f} cm >= 5 cm")
    return res


MERGE_DELTA = np.array([0.09, 0.0, -0.07], np.float32)   # tests/test_multisession.py


def run_merge_tail(dev):
    """tests/test_multisession.py::test_merge_propagates_drift_correction
    (propagate=True) on the card: session one over a ring arc, its map warped
    by MERGE_DELTA * ramp(kf id), resumed into a fresh system whose loop
    closer welds the stored map when session two revisits it; the median
    camera-centre error of the absorbed map's far end (keyframes >= 10)
    against the pre-warp map must stay under 0.35 |delta|."""
    from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    from rover_slam_tpu_torch.utils import config
    world, frames, _ = _ring_frames(60, 0.6, seed=9)
    slam = MonocularSLAM(world.cam_params, map_capacity=(96, 512, 16384), desc_dim=64,
                         device=dev)
    _reset_launches()
    _feed(slam, frames)
    st = slam.state
    n1 = slam.n_kf

    def centers(s):
        return (-torch.einsum("kji,kj->ki", s.kf_R_cw, s.kf_t_cw))[:n1].cpu().numpy()

    c_true = centers(st)
    ramp = np.clip((np.arange(st.K) - 1) / 3.0, 0.0, 1.0)
    off = torch.as_tensor((ramp[:, None] * MERGE_DELTA[None, :]).astype(np.float32), device=dev)
    c_all = -torch.einsum("kji,kj->ki", st.kf_R_cw, st.kf_t_cw)
    t_new = -torch.einsum("kij,kj->ki", st.kf_R_cw, c_all + off)
    anchor = st.lm_anchor_kf.long().clamp(0, st.K - 1)
    first = torch.arange(st.K, device=dev)[:, None] < n1
    st = st.replace(kf_t_cw=torch.where(first, t_new, st.kf_t_cw),
                    lm_pos=torch.where(st.lm_active[:, None], st.lm_pos + off[anchor],
                                       st.lm_pos))
    lc = LoopConfig(min_covis_weight=20, min_recent_kfs_gap=8, consistency_needed=2,
                    run_gba=False, welding_window=12, welding_ba_iters=10)
    slam2 = MonocularSLAM(world.cam_params, map_capacity=(96, 512, 16384), desc_dim=64,
                          enable_loop_closing=True, loop_config=lc, device=dev)
    config.resume_atlas(slam2, st)
    merged_at = None
    for i, f in enumerate(frames[:25]):
        slam2.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time + 500.0)
        if any(info.get("merge") for _, info in slam2.loop_events):
            merged_at = i
            break
    err = np.linalg.norm(centers(slam2.state) - c_true, axis=1)
    far = float(np.median(err[np.arange(n1) >= 10]))
    res = {"session_one_kfs": n1, "merged_at_frame": merged_at,
           "far_end_err_m": far, "bound_m": 0.35 * float(np.linalg.norm(MERGE_DELTA)),
           "injected_drift_m": float(np.linalg.norm(MERGE_DELTA)),
           "loop_events": loop_summary(slam2)["loop_events"], "launches": _launches()}
    log("# path F merge tail:", json.dumps(res))
    if merged_at is None:
        raise AssertionError("path F merge tail: the merge never fired")
    if not far < res["bound_m"]:
        raise AssertionError(f"path F merge tail: far-end error {far:.4f} m >= "
                             f"{res['bound_m']:.4f} m")
    return res


def phase_path_f(dev):
    return {"F sync": run_path_f(dev, 0), "F pipeline=4": run_path_f(dev, 4),
            "F merge tail": run_merge_tail(dev)}


class PathG(PathA):
    """Path G: path A's scene on orbit_with_imu's trajectory with its IMU
    samples, and a factory for MonocularInertialSLAMs."""

    def __init__(self, dev, n_frames: int = 160):
        from rover_slam_tpu_torch.utils import synthetic
        R, t, times, _, self.imu = synthetic.orbit_with_imu(
            n_frames=n_frames, orbit_radius=5.0, revs=1.1 * n_frames / 160.0,
            dt=1.0 / 30.0, hz=IMU_HZ)
        super().__init__(dev, n_frames, gt=(R, t, times))

    def new_slam(self, pipeline=0, loop=True):
        from rover_slam_tpu_torch.imu import preintegration as preint
        from rover_slam_tpu_torch.slam.inertial_system import MonocularInertialSLAM
        from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
        calib = preint.ImuCalib(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                *(np.float32(IMU_CALIB[k])
                                  for k in ("sigma_g", "sigma_a", "walk_g", "walk_a")))
        return MonocularInertialSLAM(
            self.cam, calib, tinit_s=2.0, config=self.cfg, map_capacity=(self.K, NK, self.L),
            desc_dim=D, pipeline=pipeline, enable_loop_closing=loop,
            loop_config=LoopConfig(min_covis_weight=30, fix_scale=True), matcher=self.matcher,
            device=self.dev)

    def step(self, slam, i):
        if i > 0 and hasattr(slam, "feed_imu"):
            for a, g, t in zip(*self.imu[i - 1]):
                slam.feed_imu(a, g, t)
        return self.step_image(slam, self.imgs[i], self.times[i])


def metric_ate_cm(slam, scene, after: float):
    """(metric ATE, scale-aligned ATE) in cm over the frames logged after
    time `after` (with an IMU, its init: earlier frames hold poses relative
    to pre-alignment keyframes; stereo is metric from frame 0, -inf)."""
    from rover_slam_tpu_torch.utils import trajectory
    est_t, est_R, est_tcw = slam.get_trajectory()
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    gt_pos = np.stack([-scene.R_gt[i].T @ scene.t_gt[i] for i in range(len(scene.times))])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, scene.times)
             if est_t[i] > after]
    if len(pairs) < 3 or not np.isfinite(est_pos[[i for i, _ in pairs]]).all():
        return float("nan"), float("nan")
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    return (trajectory.ate_rmse(e, g, with_scale=False)[0] * 100.0,
            trajectory.ate_rmse(e, g, with_scale=True)[0] * 100.0)


def run_path_g(scene, pipeline: int, count_syncs: bool, n_frames: int | None = None):
    """The first n_frames (None: every frame) through a fresh
    MonocularInertialSLAM (its IMU samples fed before each), then flush; the
    result line with the launches counted from 0 over the run."""
    from rover_slam_tpu_torch.slam import tracking as T
    n_frames = n_frames or len(scene.imgs)
    scene.warm_up()
    slam = scene.new_slam(pipeline=pipeline)
    _reset_launches()
    frame_ms, ready = [], None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            fire_frames = []
            for i in range(n_frames):
                t1 = time.perf_counter()
                n_loops = len(slam.loop_events)
                scene.step(slam, i)
                frame_ms.append((time.perf_counter() - t1) * 1000.0)
                if slam.imu_ready and ready is None:
                    ready = i
                if len(slam.loop_events) > n_loops:
                    fire_frames.append(i)
            slam.flush()
            _sync(scene.dev)
            wall = time.perf_counter() - t0
        finally:
            if count_syncs:
                torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    frame_ms = np.asarray(frame_ms)
    n_tracked = _tracked(slam)
    ate_metric, ate_scaled = metric_ate_cm(
        slam, scene, slam.imu_init_time if slam.imu_init_time is not None else math.inf)
    stages = slam.timers.summary()
    res = {"pipeline": pipeline, "frames": n_frames, "fps": n_frames / wall,
           "frame_ms_median": float(np.median(frame_ms)),
           "frame_ms_p95": float(np.percentile(frame_ms, 95)),
           "frame_ms_max": float(frame_ms.max()),
           "ate_metric_cm": ate_metric, "ate_scaled_cm": ate_scaled,
           "frac_tracked": n_tracked / n_frames, "frames_tracked": n_tracked,
           "frac_tracked_to_init": float(np.mean([
               e[3] == T.OK for e in slam.trajectory
               if slam.imu_init_time is not None and e[0] <= slam.imu_init_time])),
           "imu_ready_frame": ready, "scale_log": slam.scale_log,
           "loop_fire_frames": fire_frames,
           "bg": slam.bg.cpu().tolist(), "ba": slam.ba.cpu().tolist(),
           "bg_true": BG_TRUE, "ba_true": BA_TRUE,
           "vi_refines": slam.vi_refines, "vi_ba_runs": slam.vi_ba_runs,
           "pose_graph_mode": slam.loop_closer.pose_graph_mode,
           "n_kf": slam.n_kf, "n_lm": int(slam.state.n_lm),
           "host_syncs_per_frame": syncs / n_frames if count_syncs else None,
           "launches": _launches(), "trajectory_digest": trajectory_digest(slam),
           "stage_median_ms": {k: v["median_ms"] for k, v in stages.items()},
           "stage_count": {k: v["count"] for k, v in stages.items()},
           **loop_summary(slam)}
    log(f"# path G (pipeline={pipeline}):", json.dumps(res))
    return res


def _gate_path_g(r):
    name = f"path G (pipeline={r['pipeline']})"
    if r["imu_ready_frame"] is None:
        raise AssertionError(f"{name}: the IMU never initialized")
    tracked = r["frac_tracked_to_init"] if r["pipeline"] else r["frac_tracked"]
    if not tracked >= 0.9:
        raise AssertionError(f"{name} tracked only {tracked:.2f} of frames")
    if not r["pipeline"] and not (math.isfinite(r["ate_metric_cm"])
                                  and r["ate_metric_cm"] < G_ATE_BOUND_CM):
        raise AssertionError(f"{name}: metric ATE {r['ate_metric_cm']} cm, "
                             f"bound {G_ATE_BOUND_CM} cm")
    if not (r["vi_refines"] > 0 and r["vi_ba_runs"] >= 2):
        raise AssertionError(f"{name}: {r['vi_refines']} VI refinements and "
                             f"{r['vi_ba_runs']} VI-BA runs")
    if not (r["launches"]["attention"] > 0 and r["launches"]["nn"] > 0):
        raise AssertionError(f"{name}: launches {r['launches']}")


def phase_path_g_pipelined(scene):
    """Path G with pipeline=4 over the first G_PIPELINED_FRAMES frames. Every
    run of path G must initialize the IMU, refine frames and run VI-BA after
    the init and launch B1 and B2. The JAX package's pipelined inertial path
    loses tracking about 8 frames after the init on this scene (75 of 120
    frames tracked on the CPU, parity_fullwidth.py --inertial --pipeline 4;
    ROADMAP.md section C), so this run must track >= 90 % of the frames up
    to the init and its tracking after it is reported, not gated."""
    r = run_path_g(scene, 4, count_syncs=False, n_frames=G_PIPELINED_FRAMES)
    _gate_path_g(r)
    return r


def phase_path_g_sync(scene):
    """Path G synchronous twice (one digest): besides the gates of every
    path G run, each must track >= 90 % of the frames and hold the metric
    ATE under G_ATE_BOUND_CM."""
    runs = [run_path_g(scene, 0, count_syncs=True), run_path_g(scene, 0, count_syncs=False)]
    for r in runs:
        _gate_path_g(r)
    if runs[0]["trajectory_digest"] != runs[1]["trajectory_digest"]:
        raise AssertionError("path G: two synchronous runs gave different trajectories")
    return runs


def phase_path_d(scene, lost_frame: int = 60, replay_from: int = 20, replay_to: int = 100):
    """Relocalization at full width on a fresh path C system: frames up to
    lost_frame, four frames on which tracking fails (a uniform grey image,
    or the scene seen from far outside the ring if SuperPoint finds points on
    the grey), then frames replay_from.. again with the clock still running
    at 1/30 s. Tracking must go RECENTLY_LOST and back to OK through
    relocalization (PnP over one B=3 LightGlue batch against the newest
    keyframes)."""
    from rover_slam_tpu_torch.slam import tracking as T
    slam = scene.new_slam(pipeline=4)
    _reset_launches()
    for i in range(lost_frame + 1):
        scene.step(slam, i)
    grey = torch.full_like(scene.imgs[0], 0.5)
    n_kp_grey = int(scene.ext(grey)["valid"][0].sum())
    if n_kp_grey < 20:
        lost_img, lost_kind = grey, "uniform grey"
    else:
        R = scene.R_gt[lost_frame]
        C = -R.T @ scene.t_gt[lost_frame]
        lost_img, lost_kind = scene.render(R, -R @ (6.0 * C)), "far outside the ring"
    t = float(scene.times[lost_frame])
    states = []
    for _ in range(4):
        t += 1.0 / 30.0
        states.append(scene.step_image(slam, lost_img, t)["state"])
    for i in range(replay_from, replay_to):
        t += 1.0 / 30.0
        states.append(scene.step_image(slam, scene.imgs[i], t)["state"])
    slam.flush()
    logged = [e[3] for e in slam.trajectory]
    first_lost = logged.index(T.RECENTLY_LOST) if T.RECENTLY_LOST in logged else None
    back_ok = first_lost is not None and T.OK in logged[first_lost:]
    launches = _launches()
    res = {"lost_input": lost_kind, "grey_keypoints": n_kp_grey,
           "reloc_attempts": slam.reloc_attempts, "reloc_successes": slam.reloc_successes,
           "attention_launches_b3": launches["attention_by_batch"].get(3, 0),
           "went_recently_lost": first_lost is not None, "back_to_ok": back_ok,
           "final_state": slam.tracking_state,
           "frames_ok_after_loss": sum(s == T.OK for s in logged[first_lost or 0:]),
           "launches": launches}
    log("# path D:", json.dumps(res))
    if not (back_ok and slam.reloc_successes >= 1 and res["attention_launches_b3"] > 0):
        raise AssertionError("path D: no relocalization back to OK")
    return res


class PathI(PathA):
    """Path I: path C's scene (the ring photo world at 480x640, 1.1
    revolutions over 160 frames at 1/30 s) rendered as rectified stereo
    pairs at I_BASELINE with render_photo_stereo; both eyes go through
    SuperPoint as one batch of two; a factory for StereoSLAMs with loop
    closing on."""

    def render(self, R, t):
        from rover_slam_tpu_torch.utils import synthetic
        pair = np.stack(synthetic.render_photo_stereo(self.world, R, t, I_BASELINE))
        return torch.from_numpy(pair.astype(np.float32) / 255.0).to(self.dev)

    def new_slam(self):
        from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
        from rover_slam_tpu_torch.slam.stereo import StereoSLAM
        return StereoSLAM(self.cam, I_BASELINE, config=self.cfg,
                          map_capacity=(self.K, NK, self.L), desc_dim=D,
                          enable_loop_closing=True,
                          loop_config=LoopConfig(fix_scale=True, min_covis_weight=30),
                          matcher=self.matcher, device=self.dev)

    def step(self, slam, i):
        """Both eyes through SuperPoint at once, the left unprojected, then
        track_stereo_frame (the stereo match and LightGlue run inside)."""
        from rover_slam_tpu_torch.geometry import cameras
        out = self.ext(self.imgs[i])
        k, d, v = out["keypoints"], out["descriptors"], out["valid"]
        rays = cameras.unproject(cameras.PINHOLE, self.camt, k[0])
        info = slam.track_stereo_frame(k[0], rays, d[0], v[0], k[1], d[1], v[1],
                                       float(self.times[i]))
        _sync(self.dev)
        return info

    def depth_image(self, i):
        """The renderer's true depth at every pixel of frame i's left image
        (the sprite painted last at the pixel, as render_photo_frame pastes
        them; inf on the background)."""
        world, R, t = self.world, self.R_gt[i], self.t_gt[i]
        Xc = (np.asarray(R, np.float64) @ world.points.T).T + np.asarray(t, np.float64)
        z = Xc[:, 2]
        fx, fy, cx, cy = np.asarray(world.cam_params[:4], np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            u, v = fx * Xc[:, 0] / z + cx, fy * Xc[:, 1] / z + cy
        out = np.full((H, W), np.inf, np.float32)
        p0 = world.patches.shape[1]
        vis = np.where((z > 0.5) & (np.abs(u) < 2 * W) & (np.abs(v) < 2 * H))[0]
        for j in vis[np.argsort(-z[vis])]:
            zr = float(world.z0[j]) if world.z0 is not None else 8.0
            half = (max(5, min(int(round(p0 * zr / z[j])), 4 * p0)) | 1) // 2
            cy_j, cx_j = int(round(v[j])), int(round(u[j]))
            out[max(0, cy_j - half):max(0, cy_j + half + 1),
                max(0, cx_j - half):max(0, cx_j + half + 1)] = z[j]
        return out


def run_path_i(scene):
    """Every frame through a fresh StereoSLAM, then flush; the result line
    with the launches counted from 0 over the run, the stereo matches of
    each frame and the landmarks the keyframes spawned at stereo depth."""
    from rover_slam_tpu_torch.slam import stereo as st
    n_frames = len(scene.imgs)
    scene.warm_up()
    slam = scene.new_slam()
    spawned = []
    spawn = st._spawn_stereo_landmarks_kernel

    def counting_spawn(state, *a):
        out = spawn(state, *a)
        spawned.append(out.n_lm - state.n_lm)
        return out

    st._spawn_stereo_landmarks_kernel = counting_spawn
    _reset_launches()
    frame_ms, n_stereo, fire_frames = [], [], []
    try:
        t0 = time.perf_counter()
        for i in range(n_frames):
            t1 = time.perf_counter()
            n_loops = len(slam.loop_events)
            scene.step(slam, i)
            frame_ms.append((time.perf_counter() - t1) * 1000.0)
            n_stereo.append((slam._stereo_depth > 0).sum())
            if len(slam.loop_events) > n_loops:
                fire_frames.append(i)
        slam.flush()
        _sync(scene.dev)
        wall = time.perf_counter() - t0
    finally:
        st._spawn_stereo_landmarks_kernel = spawn
    launches = _launches()
    frame_ms = np.asarray(frame_ms)
    ate_metric, ate_scaled = metric_ate_cm(slam, scene, -math.inf)
    n_tracked = _tracked(slam)
    res = {"frames": n_frames, "fps": n_frames / wall,
           "frame_ms_median": float(np.median(frame_ms)),
           "frame_ms_p95": float(np.percentile(frame_ms, 95)),
           "frame_ms_max": float(frame_ms.max()),
           "stereo_matches_median": float(np.median(torch.stack(n_stereo).cpu().numpy())),
           "landmarks_from_stereo": int(sum(int(x) for x in spawned)),
           "ate_metric_cm": ate_metric, "ate_scaled_cm": ate_scaled,
           "frac_tracked": n_tracked / n_frames, "frames_tracked": n_tracked,
           "loop_fire_frames": fire_frames, "n_kf": slam.n_kf,
           "n_lm": int(slam.state.n_lm), "launches": launches,
           "trajectory_digest": trajectory_digest(slam),
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()},
           **loop_summary(slam)}
    log("# path I:", json.dumps(res))
    return res


def run_path_i_rgbd(scene, n_frames: int = I_RGBD_FRAMES):
    """RGBDSLAM over the first n_frames of path I's left images, the depth
    of each keypoint read from the renderer's true depth at its pixel plus
    1 cm of seeded noise (tests/test_map_extras.py's TestRGBD); the metric
    path length against the truth."""
    from rover_slam_tpu_torch.geometry import cameras
    from rover_slam_tpu_torch.slam.stereo import RGBDSLAM
    slam = RGBDSLAM(scene.cam, depth_factor=1.0, config=scene.cfg,
                    map_capacity=(scene.K, NK, scene.L), desc_dim=D, matcher=scene.matcher,
                    device=scene.dev)
    rng = np.random.default_rng(1)
    _reset_launches()
    t0 = time.perf_counter()
    for i in range(n_frames):
        out = scene.ext(scene.imgs[i][:1])
        kpts = out["keypoints"][0]
        px = np.clip(np.rint(kpts.cpu().numpy()).astype(np.int64), 0, (W - 1, H - 1))
        depth = scene.depth_image(i)[px[:, 1], px[:, 0]]
        depth = np.where(np.isfinite(depth), depth + rng.normal(0, 0.01, depth.shape), -1.0)
        slam.track_rgbd_frame(kpts, cameras.unproject(cameras.PINHOLE, scene.camt, kpts),
                              out["descriptors"][0], out["valid"][0], depth.astype(np.float32),
                              float(scene.times[i]))
    _sync(scene.dev)
    wall = time.perf_counter() - t0
    est_t, est_R, est_tcw = slam.get_trajectory()
    est = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    gt = np.stack([-scene.R_gt[i].T @ scene.t_gt[i] for i in range(n_frames)])
    L_est = float(np.linalg.norm(np.diff(est, axis=0), axis=1).sum())
    L_gt = float(np.linalg.norm(np.diff(gt[-len(est):], axis=0), axis=1).sum())
    res = {"frames": n_frames, "fps": n_frames / wall, "frames_tracked": _tracked(slam),
           "path_m": L_est, "path_true_m": L_gt, "path_err": abs(L_est - L_gt) / L_gt,
           "n_kf": slam.n_kf, "launches": _launches()}
    log("# path I RGBD:", json.dumps(res))
    return res


def phase_path_i(scene):
    """StereoSLAM once (its digest printed: two runs would push the whole
    script past ~900 s on a slow host), then the RGBD tail. The stereo run
    must track >= I_TRACKED_MIN of its frames, hold the metric ATE (no scale
    alignment: stereo is metric from frame 0) under I_ATE_BOUND_CM, fire a
    loop and launch B1 and B2; the RGBD tail's metric path length must lie
    within I_RGBD_PATH_TOL of the truth."""
    r = run_path_i(scene)
    if not r["frac_tracked"] >= I_TRACKED_MIN:
        raise AssertionError(f"path I tracked only {r['frac_tracked']:.2f} of frames")
    if not (math.isfinite(r["ate_metric_cm"]) and r["ate_metric_cm"] < I_ATE_BOUND_CM):
        raise AssertionError(f"path I: metric ATE {r['ate_metric_cm']} cm, "
                             f"bound {I_ATE_BOUND_CM} cm")
    if not r["n_loops"] >= 1:
        raise AssertionError("path I: no loop fired")
    if not (r["launches"]["attention"] > 0 and r["launches"]["nn"] > 0):
        raise AssertionError(f"path I: launches {r['launches']}")
    rgbd = run_path_i_rgbd(scene)
    if not rgbd["path_err"] < I_RGBD_PATH_TOL:
        raise AssertionError(f"path I RGBD: path length off by {rgbd['path_err']:.3f}")
    return r, rgbd


def path_h_settings(extra: str = "", fx: float = 458.0) -> str:
    """Path H's settings file: the reference's cv::FileStorage style."""
    return (f'%YAML:1.0\nFile.version: "1.0"\nCamera.type: "PinHole"\n'
            f"Camera1.fx: {fx}\nCamera1.fy: {fx}\nCamera1.cx: {W / 2.0}\n"
            f"Camera1.cy: {H / 2.0}\nCamera.width: {W}\nCamera.height: {H}\n"
            f"Camera.fps: 30.0\nIMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
            f"IMU.GyroWalk: 1.9e-5\nIMU.AccWalk: 3.0e-3\nIMU.Frequency: {IMU_HZ}\n"
            f"ORBextractor.nFeatures: {NK}\nloopClosing: 1\n{extra}\n")


def path_j_settings(extra: str = "") -> str:
    """Path J1's settings: path H's (loop closing on) with the rig's
    Stereo.T_c1_c2, the right camera J_BASELINE along the left camera's x,
    no rotation, as an opencv-style matrix. With no distortion coefficients
    load_settings takes the rig as rectified and reads only the norm of the
    translation."""
    T = np.eye(4)
    T[0, 3] = J_BASELINE
    data = ", ".join(repr(float(x)) for x in T.reshape(-1))
    return path_h_settings(f"Stereo.T_c1_c2:\n  rows: 4\n  cols: 4\n  dt: f\n"
                           f"  data: [{data}]\n{extra}")


def write_path_h_tree(root: str, n_frames: int = H_FRAMES, baseline: float = 0.0) -> dict:
    """Path G's scene (the ring photo world at 480x640, orbit_with_imu at
    1/30 s with its simulated IMU noise and biases) written as an EuRoC mav0/
    tree with write_euroc_sequence (with baseline > 0 a rectified stereo
    tree: cam1/ too); a reference-style settings file (PinHole,
    ORBextractor.nFeatures 1024, path G's IMU noise densities at 200 Hz,
    loopClosing 1, System.SaveAtlasToFile) and a second one that resumes
    from the saved atlas; the shipped synth weights as official-layout .pth
    files. Returns the paths."""
    from rover_slam_tpu_torch.models import weights as Wt
    from rover_slam_tpu_torch.utils import synthetic
    fx = 458.0
    cam = np.asarray([fx, fx, W / 2.0, H / 2.0, 0, 0, 0, 0], np.float32)
    world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=(H, W),
                                       layout="ring", ring_orbit_radius=5.0)
    world = world._replace(cam_params=cam)
    R, t, times, _, imu = synthetic.orbit_with_imu(
        n_frames=n_frames, orbit_radius=5.0, revs=1.1 * n_frames / 160.0,
        dt=1.0 / 30.0, hz=IMU_HZ)
    mav0, gt = synthetic.write_euroc_sequence(os.path.join(root, "mav0"), world, R, t, times,
                                              baseline=baseline, imu=imu)
    out = {"mav0": mav0, "gt": gt, "atlas": os.path.join(root, "atlas.npz"),
           "settings": os.path.join(root, "settings.yaml"),
           "settings_resume": os.path.join(root, "settings_resume.yaml"),
           "sp": os.path.join(root, "superpoint_synth.pth"),
           "lg": os.path.join(root, "lightglue_synth.pth")}
    with open(out["settings"], "w") as f:
        f.write(path_h_settings(f'System.SaveAtlasToFile: "{out["atlas"]}"'))
    with open(out["settings_resume"], "w") as f:
        f.write(path_h_settings(f'System.LoadAtlasFromFile: "{out["atlas"]}"'))
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rover_slam_tpu", "assets")
    torch.save(Wt.superpoint_state_dict(Wt.load_flat_npz(
        os.path.join(assets, "superpoint_synth.npz"))), out["sp"])
    torch.save(Wt.lightglue_official_state_dict(Wt.load_flat_npz(
        os.path.join(assets, "lightglue_synth.npz")), LIGHTGLUE_LAYERS), out["lg"])
    return out


def _frame_stats(log_path: str) -> dict:
    from rover_slam_tpu_torch.slam import tracking as T
    with open(log_path) as f:
        fl = json.load(f)
    fr = fl["frames"]
    total = np.asarray([x["read_ms"] + x.get("read_r_ms", 0.0) + x["extract_ms"] + x["track_ms"]
                        for x in fr])
    right = {}
    if "read_r_ms" in fr[0]:    # the stereo sensors' right eye
        right = {"read_r_ms_median": float(np.median([x["read_r_ms"] for x in fr])),
                 "read_r_ms_max": float(max(x["read_r_ms"] for x in fr))}
    ready = [i for i, x in enumerate(fr) if x["imu_ready"]]
    return {"frames": len(fr), "fps": len(fr) / fl["wall_s"],
            "frame_ms_median": float(np.median(total)),
            "frame_ms_p95": float(np.percentile(total, 95)),
            "frame_ms_max": float(total.max()),
            "read_ms_median": float(np.median([x["read_ms"] for x in fr])),
            "read_ms_max": float(max(x["read_ms"] for x in fr)), **right,
            "extract_ms_median": float(np.median([x["extract_ms"] for x in fr])),
            "track_ms_median": float(np.median([x["track_ms"] for x in fr])),
            "frames_tracked": sum(x["state"] == T.OK for x in fr),
            "imu_ready_frame": ready[0] if ready else None,
            "imu_init_scale": next((v for k, v in fl["scale_log"] if k == "init"), None),
            "n_kf_loaded": fl["n_kf_loaded"]}


def _write_png_gray8(path: str, img: np.ndarray):
    """An 8-bit gray PNG, rows alternately unfiltered and Up-filtered."""
    import zlib

    def chunk(tag, body):
        return (len(body).to_bytes(4, "big") + tag + body
                + zlib.crc32(tag + body).to_bytes(4, "big"))

    h, w = img.shape
    prev = np.zeros(w, np.uint8)
    rows = []
    for y in range(h):
        up = y % 2 == 1
        rows.append((b"\x02" if up else b"\x00") + (img[y] - prev if up else img[y]).tobytes())
        prev = img[y]
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 0, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def png_prefetch_check(tree: dict, tmp_root: str) -> dict:
    """Real EuRoC trees hold PNG frames: the first frame of the tree,
    rewritten as PNG, must come through ImagePrefetcher equal to its PGM
    (natively with libpng, else through the pure-Python reader)."""
    from rover_slam_tpu_torch.utils import dataset
    pgm = dataset.load_euroc_sequence(tree["mav0"])["image_paths"][0]
    img = dataset.read_image(pgm)
    png = os.path.join(tmp_root, "frame0.png")
    _write_png_gray8(png, img)
    t0 = time.perf_counter()
    pf = dataset.ImagePrefetcher([png, pgm, png], depth=2)
    try:
        got = [pf.get(i) for i in range(3)]
    finally:
        pf.close()
    if not all(np.array_equal(g, img) for g in got):
        raise AssertionError("path H: a PNG frame prefetched unequal to its PGM")
    return {"native_png": bool(dataset._lib.dataset_has_png()),
            "png_prefetch_ms": (time.perf_counter() - t0) * 1e3}


def phase_path_h(tmp_root: str):
    """The EuRoC app on the card: write_path_h_tree, then session 1,
    run_euroc.main with the monocular-inertial sensor, both official-layout
    checkpoints (SuperPoint, and LightGlue as the frame matcher: B1), --gt,
    --stats-out and the atlas saved through the settings; the atlas passes
    the checksum gate; the port's ATE CLI scores session 1's TUM file
    (metric: --no_scale); session 2 resumes the atlas through
    System.LoadAtlasFromFile for a short monocular run over the first
    frames. Before the sessions, png_prefetch_check reads a PNG frame
    through the prefetcher. Fails when an app run does not return 0, the
    IMU does not initialize, session 1 tracks under H_TRACKED_MIN of its
    frames or its metric ATE exceeds H_ATE_BOUND_CM, the checksum gate
    refuses the atlas, session 2 does not load the stored keyframes, or
    B1 / B2 were not launched."""
    from rover_slam_tpu_torch.apps import run_euroc
    from rover_slam_tpu_torch.map import atlas
    t_w = time.perf_counter()
    tree = write_path_h_tree(tmp_root)
    write_s = time.perf_counter() - t_w
    png = png_prefetch_check(tree, tmp_root)
    common = ["--superpoint-ckpt", tree["sp"], "--lightglue-ckpt", tree["lg"]]
    s1 = {k: os.path.join(tmp_root, f"session1_{k}") for k in ("traj", "stats", "frames")}
    _reset_launches()
    rc1 = run_euroc.main([tree["settings"], tree["mav0"], "--sensor", "monocular-inertial",
                          "--out", s1["traj"], "--gt", tree["gt"], "--stats-out", s1["stats"],
                          "--frame-log", s1["frames"], *common])
    l1 = _launches()
    if rc1 != 0:
        raise AssertionError(f"path H session 1: run_euroc returned {rc1}")
    with open(s1["stats"]) as f:
        stats1 = json.load(f)
    fs1 = _frame_stats(s1["frames"])
    stored = atlas.load_atlas(tree["atlas"])            # the checksum gate
    stored_kf = int(stored.n_kf)
    cli = subprocess.run([sys.executable, "-m", "rover_slam_tpu_torch.apps.evaluate_ate_scale",
                          tree["gt"], s1["traj"], "--no_scale"], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)), timeout=120)
    if cli.returncode != 0:
        raise AssertionError(f"path H: evaluate_ate_scale failed: {cli.stderr}")
    cli_rmse, cli_scale = (float(x) for x in cli.stdout.strip().split(","))
    s2 = {k: os.path.join(tmp_root, f"session2_{k}") for k in ("traj", "stats", "frames")}
    _reset_launches()
    rc2 = run_euroc.main([tree["settings_resume"], tree["mav0"], "--sensor", "monocular",
                          "--out", s2["traj"], "--stats-out", s2["stats"],
                          "--frame-log", s2["frames"], "--max-frames", str(H_RESUME_FRAMES),
                          *common])
    l2 = _launches()
    if rc2 != 0:
        raise AssertionError(f"path H session 2: run_euroc returned {rc2}")
    fs2 = _frame_stats(s2["frames"])
    launches = {k: l1[k] + l2[k] for k in ("attention", "nn", "pose_opt")}
    launches["attention_by_batch"] = l1["attention_by_batch"]
    launches["nn_by_shape"] = l1["nn_by_shape"]
    res = {"tree_write_s": write_s, "png": png, "session1": {**fs1, **stats1,
                                                 "ate_cli_m": cli_rmse,
                                                 "ate_cli_scale": cli_scale},
           "atlas_kf": stored_kf,
           "session2": {**fs2, "n_kf": json.load(open(s2["stats"]))["n_kf"]},
           "launches_session1": {"attention": l1["attention"], "nn": l1["nn"]},
           "launches_session2": {"attention": l2["attention"], "nn": l2["nn"]},
           "launches": launches}
    log("# path H:", json.dumps(res))
    if fs1["imu_ready_frame"] is None or not stats1["imu_ready"]:
        raise AssertionError("path H: the IMU never initialized")
    if not fs1["frames_tracked"] >= H_TRACKED_MIN * fs1["frames"]:
        raise AssertionError(f"path H tracked only {fs1['frames_tracked']} of "
                             f"{fs1['frames']} frames")
    ate = stats1["ate_cm"]
    if not (ate is not None and math.isfinite(ate) and ate < H_ATE_BOUND_CM):
        raise AssertionError(f"path H: metric ATE {ate} cm, bound {H_ATE_BOUND_CM} cm")
    if not abs(cli_rmse * 100.0 - ate) < 1e-3:
        raise AssertionError(f"path H: ATE CLI {cli_rmse} m against the app's {ate} cm")
    if not (stored_kf == stats1["n_kf"] and fs2["n_kf_loaded"] == stored_kf > 0):
        raise AssertionError(f"path H: session 2 loaded {fs2['n_kf_loaded']} keyframes of "
                             f"{stored_kf} stored (session 1: {stats1['n_kf']})")
    if not (launches["attention"] > 0 and launches["nn"] > 0):
        raise AssertionError(f"path H: launches {launches}")
    return res


def write_path_j_tree(root: str, n_frames: int = H_FRAMES) -> dict:
    """Path J1's tree: path H's scene and weights written as a rectified
    stereo tree (cam1/ rendered J_BASELINE to the right), with path J's
    settings. Returns the paths."""
    tree = write_path_h_tree(root, n_frames, baseline=J_BASELINE)
    with open(tree["settings"], "w") as f:
        f.write(path_j_settings())
    return tree


def run_path_j1(tmp_root: str) -> dict:
    """The stereo-inertial app on path J1's tree with both official-layout
    checkpoints, --gt, --stats-out and --frame-log; the launches counted
    from 0 over the run, the stereo points of each frame and the landmarks
    spawned at stereo depth, read through the system the app builds."""
    from rover_slam_tpu_torch.apps import run_euroc
    from rover_slam_tpu_torch.slam import stereo as st
    t_w = time.perf_counter()
    tree = write_path_j_tree(tmp_root)
    write_s = time.perf_counter() - t_w
    out = {k: os.path.join(tmp_root, f"j1_{k}") for k in ("traj", "stats", "frames")}
    built, n_stereo, spawned = [], [], []
    build, spawn = run_euroc.build_system, st._spawn_stereo_landmarks_kernel

    def building(*a, **k):
        slam = build(*a, **k)
        built.append(slam)
        track = slam.track_stereo_frame

        def track_stereo_frame(*aa, **kk):
            info = track(*aa, **kk)
            n_stereo.append((slam._stereo_depth > 0).sum())
            return info

        slam.track_stereo_frame = track_stereo_frame
        return slam

    def counting_spawn(state, *a):
        new = spawn(state, *a)
        spawned.append(new.n_lm - state.n_lm)
        return new

    run_euroc.build_system, st._spawn_stereo_landmarks_kernel = building, counting_spawn
    _reset_launches()
    try:
        rc = run_euroc.main([tree["settings"], tree["mav0"], "--sensor", "stereo-inertial",
                             "--out", out["traj"], "--gt", tree["gt"],
                             "--stats-out", out["stats"], "--frame-log", out["frames"],
                             "--superpoint-ckpt", tree["sp"], "--lightglue-ckpt", tree["lg"]])
    finally:
        run_euroc.build_system, st._spawn_stereo_landmarks_kernel = build, spawn
    launches = _launches()
    if rc != 0:
        raise AssertionError(f"path J1: run_euroc returned {rc}")
    slam, = built
    with open(out["stats"]) as f:
        stats = json.load(f)
    res = {"tree_write_s": write_s, **_frame_stats(out["frames"]), **stats,
           "bg": slam.bg.cpu().tolist(), "ba": slam.ba.cpu().tolist(),
           "bg_true": BG_TRUE, "ba_true": BA_TRUE,
           "stereo_matches_median": float(torch.stack(n_stereo).float().median()),
           "landmarks_from_stereo": int(sum(int(x) for x in spawned)),
           "vi_refines": slam.vi_refines, "vi_ba_runs": slam.vi_ba_runs,
           "n_lm": int(slam.state.n_lm), "launches": launches,
           "trajectory_digest": trajectory_digest(slam),
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()}}
    log("# path J1:", json.dumps(res))
    return res


def fisheye_rig():
    """tests/test_fisheye_stereo.py's TUM-VI-like rig: KB8 intrinsics at
    512x512 and the left camera in the right one's frame, R_rl =
    exp([0, 0.02, 0]), t_rl = [-0.101, 0.002, 0.001]."""
    from rover_slam_tpu_torch.geometry import cameras, lie
    kb8 = cameras.make_kb8(190.978, 190.973, 254.932, 256.897, 0.00348238, 0.000715034,
                           -0.00205323, 0.000202936).numpy()
    R_rl = lie.so3_exp(torch.tensor([0.0, 0.02, 0.0])).numpy()
    return kb8, R_rl, np.asarray([-0.101, 0.002, 0.001], np.float32)


def fisheye_world(seed: int):
    """A 1600-landmark ring world (64-D) seen through the KB8 camera."""
    from rover_slam_tpu_torch.geometry import cameras
    from rover_slam_tpu_torch.utils import synthetic
    kb8, _, _ = fisheye_rig()
    base = synthetic.ring_world(n_landmarks=1600, desc_dim=64, seed=seed)
    return synthetic.SyntheticWorld(landmarks=base.landmarks, desc=base.desc, cam_params=kb8,
                                    cam_kind=cameras.KANNALA_BRANDT8, image_hw=(512, 512))


def fisheye_stereo_frames(world, R_gt, t_gt, times, **kw):
    """Both eyes' synthetic frames: the left at the trajectory, the right
    through the rig (tests/test_fisheye_stereo.py::_right_pose)."""
    from rover_slam_tpu_torch.utils import synthetic
    _, R_rl, t_rl = fisheye_rig()
    R_r = np.einsum("ij,kjl->kil", R_rl, np.asarray(R_gt)).astype(np.float32)
    t_r = (np.einsum("ij,kj->ki", R_rl, np.asarray(t_gt)) + t_rl).astype(np.float32)
    return (synthetic.render_sequence(world, R_gt, t_gt, times, **kw),
            synthetic.render_sequence(world, R_r, t_r, times, **kw))


def fisheye_stereo_scene(n_frames: int = 30):
    """tests/test_fisheye_stereo.py's sequence: world seed 4,
    forward_trajectory at 0.5 m/s over n_frames at dt 0.1, 512 keypoints.
    Returns (left, right, (R_gt, t_gt, times), None)."""
    from rover_slam_tpu_torch.utils import synthetic
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=n_frames, dt=0.1, speed=0.5,
                                                     yaw_rate=0.03)
    left, right = fisheye_stereo_frames(fisheye_world(4), R_gt, t_gt, times, n_kpts=512,
                                        pix_noise=0.4, desc_noise=0.05)
    return left, right, (R_gt, t_gt, times), None


def fisheye_si_scene(n_frames: int = 50):
    """tests/test_fisheye_inertial.py's sequence with a right eye: world
    seed 2, orbit_with_imu over 50 frames at dt 0.1 (the first n_frames),
    512 keypoints. Returns (left, right, (R_gt, t_gt, times), imu)."""
    from rover_slam_tpu_torch.utils import synthetic
    R_gt, t_gt, times, _, imu = synthetic.orbit_with_imu(n_frames=50, revs=0.5, dt=0.1)
    R_gt, t_gt, times = R_gt[:n_frames], t_gt[:n_frames], times[:n_frames]
    left, right = fisheye_stereo_frames(fisheye_world(2), R_gt, t_gt, times, n_kpts=512,
                                        pix_noise=0.5, desc_noise=0.05)
    return left, right, (R_gt, t_gt, times), imu


# tests/test_fisheye_inertial.py's TUM-VI IMU noise at 200 Hz.
FISHEYE_IMU = dict(sigma_g=0.00016 * math.sqrt(200.0), sigma_a=0.0028 * math.sqrt(200.0),
                   walk_g=0.000022 / math.sqrt(200.0), walk_a=0.00086 / math.sqrt(200.0))


def run_fisheye(scene, cls, calib=None, **kw):
    """Every frame of a fisheye scene through a fresh system of class cls
    (built as the tests build it, its IMU samples fed before each frame);
    per frame its tracking state, stereo points, IMU readiness and the B2
    reduces its fisheye stereo match launched. Returns (slam, per-frame
    records, wall seconds)."""
    from rover_slam_tpu_torch.geometry import cameras
    from rover_slam_tpu_torch.slam import stereo as st, tracking as T
    left, right, _, imu = scene
    kb8, R_rl, t_rl = fisheye_rig()
    cfg = T.TrackerConfig(cam_kind=cameras.KANNALA_BRANDT8, image_hw=(512, 512))
    args = (kb8,) + ((calib,) if calib is not None else ()) + ((R_rl, t_rl),)
    slam = cls(*args, config=cfg, desc_dim=64, **kw)
    match, match_reduces = st.fisheye_stereo_match_kernel, []

    def counting_match(*a, **k):
        before = counter("nn_launches")
        out = match(*a, **k)
        match_reduces.append(counter("nn_launches") - before)
        return out

    st.fisheye_stereo_match_kernel = counting_match
    rec = []
    try:
        t0 = time.perf_counter()
        for i, (fl, fr) in enumerate(zip(left, right)):
            if i > 0 and imu is not None:
                for a, g, t in zip(*imu[i - 1]):
                    slam.feed_imu(a, g, t)
            state = slam.track_stereo_frame(fl.kpts, fl.rays, fl.desc, fl.valid,
                                            fr.rays, fr.desc, fr.valid, fl.time)["state"]
            rec.append((int(state), slam._stereo_depth, bool(getattr(slam, "imu_ready", False))))
        _sync(slam.device)
        wall = time.perf_counter() - t0
    finally:
        st.fisheye_stereo_match_kernel = match
    rec = [(s, int((d > 0).sum()), r, n) for (s, d, r), n in zip(rec, match_reduces)]
    return slam, rec, wall


def fisheye_ate_cm(slam, scene, after_frame=None) -> float:
    """Metric ATE (Horn without scale) in cm over the frames after
    after_frame (None: every frame)."""
    from rover_slam_tpu_torch.utils import trajectory
    R_gt, t_gt, times = scene[2]
    est_t, est_R, est_tcw = slam.get_trajectory()
    est = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    gt = np.stack([-np.asarray(R).T @ np.asarray(t) for R, t in zip(R_gt, t_gt)])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times)
             if after_frame is None or j > after_frame]
    return 100.0 * trajectory.ate_rmse(np.stack([est[i] for i, _ in pairs]),
                                       np.stack([gt[j] for _, j in pairs]),
                                       with_scale=False)[0]


def run_path_j2(dev) -> dict:
    """The fisheye tail, no networks: FisheyeStereoSLAM on
    fisheye_stereo_scene, then FisheyeStereoInertialSLAM on
    fisheye_si_scene; the launches counted from 0 over both."""
    from rover_slam_tpu_torch.imu import preintegration as preint
    from rover_slam_tpu_torch.slam import tracking as T
    from rover_slam_tpu_torch.slam.stereo import FisheyeStereoSLAM
    from rover_slam_tpu_torch.slam.stereo_inertial import FisheyeStereoInertialSLAM
    _reset_launches()
    out = {}
    scene = fisheye_stereo_scene()
    slam, rec, wall = run_fisheye(scene, FisheyeStereoSLAM, map_capacity=(64, 512, 16384),
                                  device=dev)
    out["stereo"] = {"frames": len(rec), "fps": len(rec) / wall,
                     "final_state": int(slam.tracking_state), "n_kf": slam.n_kf,
                     "ate_metric_cm": fisheye_ate_cm(slam, scene),
                     "frames_tracked": sum(r[0] == T.OK for r in rec),
                     "stereo_points_median": float(np.median([r[1] for r in rec])),
                     "match_reduces_min": min(r[3] for r in rec)}
    scene = fisheye_si_scene()
    calib = preint.ImuCalib(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                            *(np.float32(FISHEYE_IMU[k])
                              for k in ("sigma_g", "sigma_a", "walk_g", "walk_a")))
    slam, rec, wall = run_fisheye(scene, FisheyeStereoInertialSLAM, calib,
                                  map_capacity=(96, 512, 16384), device=dev)
    ready = [i for i, r in enumerate(rec) if r[2]]
    out["stereo_inertial"] = {
        "frames": len(rec), "fps": len(rec) / wall, "final_state": int(slam.tracking_state),
        "imu_ready": slam.imu_ready, "imu_ready_frame": ready[0] if ready else None,
        "n_kf": slam.n_kf, "frames_tracked": sum(r[0] == T.OK for r in rec),
        "ate_metric_cm": fisheye_ate_cm(slam, scene, ready[0]) if ready else float("nan"),
        "bg": slam.bg.cpu().tolist(), "ba": slam.ba.cpu().tolist(),
        "stereo_points_median": float(np.median([r[1] for r in rec])),
        "match_reduces_min": min(r[3] for r in rec)}
    out["launches"] = _launches()
    log("# path J2:", json.dumps(out))
    return out


def phase_path_j(tmp_root: str):
    """J1, the stereo-inertial app: returns 0, tracks >= J_TRACKED_MIN of
    its frames, initializes the IMU, launches B1 and B2, and holds the
    metric ATE (the app's: Horn without scale over every frame) under
    J_ATE_BOUND_CM. J2, the fisheye tail: both systems end in OK, the
    stereo run's metric ATE under tests/test_fisheye_stereo.py's 10 cm, the
    stereo-inertial run initializes the IMU and holds its metric ATE after
    the init under J2_SI_ATE_BOUND_CM, and every stereo frame's fisheye
    match launched B2 (its two reduces)."""
    from rover_slam_tpu_torch.slam import tracking as T
    j1 = run_path_j1(tmp_root)
    if not j1["imu_ready"] or j1["imu_ready_frame"] is None:
        raise AssertionError("path J1: the IMU never initialized")
    if not j1["frames_tracked"] >= J_TRACKED_MIN * j1["frames"]:
        raise AssertionError(f"path J1 tracked only {j1['frames_tracked']} of "
                             f"{j1['frames']} frames")
    ate = j1["ate_cm"]
    if not (ate is not None and math.isfinite(ate) and ate < J_ATE_BOUND_CM):
        raise AssertionError(f"path J1: metric ATE {ate} cm, bound {J_ATE_BOUND_CM} cm")
    if not (j1["launches"]["attention"] > 0 and j1["launches"]["nn"] > 0):
        raise AssertionError(f"path J1: launches {j1['launches']}")
    j2 = run_path_j2(torch.device("cuda", 0))
    fs, fsi = j2["stereo"], j2["stereo_inertial"]
    for name, r in (("stereo", fs), ("stereo-inertial", fsi)):
        if r["final_state"] != T.OK:
            raise AssertionError(f"path J2 {name}: final state {r['final_state']}")
        if not r["match_reduces_min"] >= 2:
            raise AssertionError(f"path J2 {name}: a fisheye match launched "
                                 f"{r['match_reduces_min']} B2 reduces")
    if not fs["ate_metric_cm"] < 10.0:
        raise AssertionError(f"path J2 stereo: metric ATE {fs['ate_metric_cm']} cm")
    if not (fsi["imu_ready"] and math.isfinite(fsi["ate_metric_cm"])
            and fsi["ate_metric_cm"] < J2_SI_ATE_BOUND_CM):
        raise AssertionError(f"path J2 stereo-inertial: imu_ready {fsi['imu_ready']}, "
                             f"metric ATE {fsi['ate_metric_cm']} cm, "
                             f"bound {J2_SI_ATE_BOUND_CM} cm")
    return j1, j2


class StepWatch:
    """The trainers' on_step callback: after every step, synchronize, stamp
    the host clock and read the kernel counters; `first(model)` runs after
    step 0 with its gradients on the parameters."""

    def __init__(self, first=None):
        self.first, self.stamps, self.counts = first, [], []

    def __call__(self, it, model):
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        self.counts.append(_launches())
        if it == 0 and self.first is not None:
            self.first(model)

    def step_ms(self) -> float:
        """Median host time of a step (batch, step, synchronize), over the
        steps from K_TIMED_FROM on."""
        return float(np.median(np.diff(self.stamps)[K_TIMED_FROM - 1:]) * 1e3)


def _loss_gate(name, losses):
    """Every loss finite; the mean of the last 5 below the first step's."""
    loss = losses[:, 0]
    if not np.isfinite(losses).all():
        raise AssertionError(f"path {name}: a loss is not finite: {losses.tolist()}")
    if not loss[-5:].mean() < loss[0]:
        raise AssertionError(f"path {name}: the loss did not fall: first {loss[0]}, "
                             f"last 5 {loss[-5:].tolist()}")


def k2_gradient_parity(dev):
    """One K2 batch (4 held-out pairs, shipped SuperPoint, 512 keypoints)
    through a fresh LightGlue: the gradient with B1 against the gradient
    with masked_attention_f32p and with masked_attention_plain swapped in,
    cosine >= K_GRAD_COS for every parameter tensor (cross attention's key
    biases excepted: their gradient is 0, the softmax ignoring a shift of a
    row). Its launches are not counted."""
    from rover_slam_tpu_torch.models import lightglue as lgm, weights as Wt
    from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor
    from rover_slam_tpu_torch.ops import flash_attention as fa
    from rover_slam_tpu_torch.training import checkpoints, lightglue_train as lgt
    saved = snapshot_counters()
    ext = SuperPointExtractor(params=checkpoints.load_params(lgt.SHIPPED_SP),
                              max_keypoints=512, device=dev)
    ds = lgt.make_dataset(ext, np.random.default_rng(7), 4, image_hw=K_HW, n_kpts=512)
    batch = {k: torch.from_numpy(np.stack([b[k] for b in ds])).to(dev) for k in ds[0]}
    model = Wt.flax_init_(lgm.LightGlue(num_layers=LIGHTGLUE_LAYERS),
                          torch.Generator().manual_seed(0)).to(dev)
    grads = {}
    for name, fn in (("kernel", fa.masked_attention), ("f32p", masked_attention_f32p),
                     ("plain", fa.masked_attention_plain)):
        model.zero_grad(set_to_none=True)
        lgm.masked_attention = fn
        try:
            lgt.loss_fn(model, batch)[0].backward()
        finally:
            lgm.masked_attention = fa.masked_attention
        grads[name] = {n: p.grad.double() for n, p in model.named_parameters()
                       if not n.endswith("cross_attn.to_k.bias")}
    reset_counters(saved)
    worst = {}
    for ref in ("f32p", "plain"):
        cos = {n: float((g * grads[ref][n]).sum() / (g.norm() * grads[ref][n].norm()))
               for n, g in grads["kernel"].items()}
        worst[ref] = min(cos.items(), key=lambda kv: kv[1])
    log("# path K2 gradient, B1 against plain attentions (worst tensor cosine):",
        json.dumps(worst))
    for ref, (n, c) in worst.items():
        if not c >= K_GRAD_COS:
            raise AssertionError(f"path K2 gradient: {n} cosine {c} against {ref}")
    return worst


def _first_step_grads(model):
    """K2's first step: every gradient finite, every to_q / to_k / to_v
    weight's gradient nonzero (a detached kernel output would leave them 0)."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    zero = [n for n, p in model.named_parameters()
            if n.split(".")[-2] in ("to_q", "to_k", "to_v") and n.endswith("weight")
            and not bool((p.grad != 0).any())]
    n_qkv = sum(n.split(".")[-2] in ("to_q", "to_k", "to_v") and n.endswith("weight")
                for n, _ in model.named_parameters())
    log(f"# path K2 step 0: {len(bad)} gradients not finite, {len(zero)} of {n_qkv} "
        f"to_q/to_k/to_v weight gradients zero")
    if bad or zero or n_qkv != LIGHTGLUE_LAYERS * 2 * 3:
        raise AssertionError(f"path K2 step 0: not finite {bad}, zero {zero}")


def phase_path_k(tmp_root: str):
    """K1-K4 (see the module docstring), counted from one reset. Gates:
    every loss finite and the mean of the last 5 under the first, in K1 and
    K2; K1's evaluation launches B2; K2's step 0 passes _first_step_grads;
    K2's steps launch B1 at least 4 x LIGHTGLUE_LAYERS times a step and
    recompute a backward for every one of those launches; K3's saved keys
    are those of the shipped lightglue_synth.npz, in float16, and the
    loaded matcher's matches and scores equal the trained model's on a
    held-out pair; K4 returns 0 and its trace holds the demo's spans."""
    from rover_slam_tpu_torch.models.lightglue import LightGlueMatcher
    from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor
    from rover_slam_tpu_torch.slam import demo
    from rover_slam_tpu_torch.training import checkpoints
    from rover_slam_tpu_torch.training import lightglue_train as lgt, superpoint_train as spt
    from rover_slam_tpu_torch.utils import profiling
    dev = torch.device("cuda", 0)
    t_k = time.perf_counter()
    grad_parity = k2_gradient_parity(dev)
    res = {"gradient_parity": grad_parity}
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    start1 = torch.cuda.memory_allocated()
    w1 = StepWatch()
    r1 = spt.train(steps=K1_STEPS, batch=4, lr=1e-3, image_hw=K_HW, pool=K1_POOL,
                   log_every=10, device=dev, on_step=w1)
    l1 = _launches()
    res["K1"] = {"step_ms": w1.step_ms(), "pool_s": r1.setup_s,
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "peak_over_start": torch.cuda.max_memory_allocated() - start1,
                 "loss_first": r1.losses[0].tolist(), "loss_last": r1.losses[-1].tolist(),
                 "heldout_precision": float(r1.heldout[0]),
                 "heldout_matches_per_pair": float(r1.heldout[1]),
                 "nn_in_training": w1.counts[-1]["nn"], "nn_in_eval": l1["nn"] - w1.counts[-1]["nn"]}
    _loss_gate("K1", r1.losses)
    if not res["K1"]["nn_in_eval"] > 0:
        raise AssertionError("path K1: the evaluation launched no B2")

    torch.cuda.reset_peak_memory_stats()
    start2 = torch.cuda.memory_allocated()
    w2 = StepWatch(first=_first_step_grads)
    r2 = lgt.train(lgt.SHIPPED_SP, steps=K2_STEPS, batch=4, lr=2e-4, n_pairs=K2_PAIRS,
                   num_layers=LIGHTGLUE_LAYERS, image_hw=K_HW, n_kpts=512, log_every=10,
                   device=dev, on_step=w2)
    l2 = _launches()
    fwd = w2.counts[-1]["attention"] - l1["attention"]
    bwd = w2.counts[-1]["attention_backward"] - l1["attention_backward"]
    res["K2"] = {"step_ms": w2.step_ms(), "dataset_s": r2.setup_s,
                 "max_memory_allocated": torch.cuda.max_memory_allocated(),
                 "peak_over_start": torch.cuda.max_memory_allocated() - start2,
                 "loss_first": r2.losses[0].tolist(), "loss_last": r2.losses[-1].tolist(),
                 "heldout_precision": float(r2.heldout[0]),
                 "heldout_recall": float(r2.heldout[1]),
                 "attention_in_training": fwd, "attention_backward": bwd,
                 "attention_in_eval": l2["attention"] - w2.counts[-1]["attention"]}
    _loss_gate("K2", r2.losses)
    if not (fwd >= 4 * LIGHTGLUE_LAYERS * K2_STEPS and bwd == fwd):
        raise AssertionError(f"path K2: {fwd} B1 launches under grad and {bwd} backward "
                             f"recomputes in {K2_STEPS} steps")

    ext = SuperPointExtractor(params=checkpoints.load_params(lgt.SHIPPED_SP),
                              max_keypoints=512, device=dev)
    pair = lgt.make_dataset(ext, np.random.default_rng(101), 1, image_hw=K_HW, n_kpts=512)[0]
    args = [torch.from_numpy(pair[k][None]).to(dev) for k in ("k0", "d0", "v0", "k1", "d1", "v1")]
    f16, f32 = (os.path.join(tmp_root, f"lightglue_k2_{n}.npz") for n in ("f16", "f32"))
    checkpoints.save_params(f16, r2.params)
    checkpoints.save_params(f32, r2.params, dtype=np.float32)
    shipped = os.path.join(os.path.dirname(lgt.SHIPPED_SP), "lightglue_synth.npz")
    with np.load(f16) as z, np.load(shipped) as ref:
        same_keys = sorted(z.files) == sorted(ref.files)
        f16_only = all(z[k].dtype == np.float16 for k in z.files)
    loaded = LightGlueMatcher(params=checkpoints.load_params(f32), num_layers=LIGHTGLUE_LAYERS,
                              threshold=0.1, device=dev)(*args)
    trained = lgt._RawMatcher(r2.model, threshold=0.1)(*args)
    exact = all(torch.equal(loaded[k], trained[k]) for k in ("matches0", "mscores0"))
    res["K3"] = {"keys_equal_shipped": same_keys, "float16": f16_only, "matches_equal": exact,
                 "matches": int((trained["matches0"] >= 0).sum())}
    if not (same_keys and f16_only and exact):
        raise AssertionError(f"path K3: {res['K3']}")

    trace_dir = os.path.join(tmp_root, "demo_trace")
    t_d = time.perf_counter()
    rc = demo.main(["--frames", str(K_DEMO_FRAMES), "--trace", trace_dir])
    demo_s = time.perf_counter() - t_d
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        text = f.read()
    spans = ['"frame#0"', f'"frame#{K_DEMO_FRAMES - 1}"', '"track_frame"']
    res["K4"] = {"rc": rc, "s": demo_s, "trace_mb": len(text) / 2**20,
                 "spans": {sp: sp in text for sp in spans},
                 "kernel_events": text.count('"cat": "kernel"')}
    if not (rc == 0 and all(res["K4"]["spans"].values())):
        raise AssertionError(f"path K4: {res['K4']}")
    res["launches"] = _launches()
    res["s"] = time.perf_counter() - t_k
    res["card"] = card()
    log("# path K:", json.dumps(res))
    return res


# Paths run in worker processes beside the main process's first paths, one
# group a process: every path is host-bound (the card is busy under a tenth
# of a frame), so three processes share the card at little cost to each.
# The groups are balanced on the seconds by phase of one process. The paths
# whose gates hold two runs equal to the bit (E's two runs, L2 against E
# run 1, G's two synchronous runs) run after the workers have ended, alone
# on the card: a loop closer reads its detection packs once they have
# landed (HostCopy.ready), and beside another process's work the card lands
# them later, which moves a loop event by a frame or two (F's and I's ATEs
# move within their bounds; A, B, C, D, G's pipelined run, H, J and K come
# out as alone).
WORKER_GROUPS = (("H", "I", "K"), ("F", "J"))


def _phase_f(dev):
    return phase_path_f(dev)


def _phase_h(dev):
    with tempfile.TemporaryDirectory(prefix="path_h_") as tmp_root:
        return {"H": phase_path_h(tmp_root)}


def _phase_i(dev):
    return dict(zip(("I", "I RGBD"), phase_path_i(PathI(dev, n_frames=160))))


def _phase_j(dev):
    with tempfile.TemporaryDirectory(prefix="path_j_") as tmp_root:
        return dict(zip(("J1", "J2"), phase_path_j(tmp_root)))


def _phase_k(dev):
    with tempfile.TemporaryDirectory(prefix="path_k_") as tmp_root:
        return {"K": phase_path_k(tmp_root)}


WORKER_PHASES = {"F": _phase_f, "H": _phase_h, "I": _phase_i, "J": _phase_j,
                 "K": _phase_k}


class Marks:
    """Seconds by phase of one process."""

    def __init__(self):
        self.t = [time.perf_counter()]
        self.names = []

    def __call__(self, name):
        self.t.append(time.perf_counter())
        self.names.append(name)

    def seconds(self) -> dict:
        return {n: round(self.t[i + 1] - self.t[i], 1) for i, n in enumerate(self.names)}


def worker_main(group: str, out_path: str):
    """Run the paths of one worker group and write their launches and
    seconds by phase to out_path as JSON."""
    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG: dies with the script
    dev = torch.device("cuda", 0)
    marks = Marks()
    paths = {}
    for name in group.split(","):
        paths.update(WORKER_PHASES[name](dev))
        marks(name)
    with open(out_path, "w") as f:
        json.dump({"launches": {k: p["launches"] for k, p in paths.items()},
                   "seconds": marks.seconds()}, f)


class Workers:
    """The worker processes: started together, polled between the main
    sequence's phases (a failed worker fails the script at once), joined at
    the end, and killed if the script fails."""

    def __init__(self, tmp: str):
        self.procs = []
        for group in WORKER_GROUPS:
            out = os.path.join(tmp, "worker_" + "".join(group) + ".json")
            p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                  ",".join(group), out])
            self.procs.append((",".join(group), out, p))

    def poll(self):
        for group, _, p in self.procs:
            rc = p.poll()
            if rc not in (None, 0):
                raise RuntimeError(f"worker {group} failed with exit code {rc}")

    def join(self, timeout: float) -> list:
        t_end = time.perf_counter() + timeout
        results = []
        for group, out, p in self.procs:
            rc = p.wait(timeout=max(1.0, t_end - time.perf_counter()))
            if rc != 0:
                raise RuntimeError(f"worker {group} failed with exit code {rc}")
            with open(out) as f:
                results.append((group, json.load(f)))
        return results

    def kill(self):
        for _, _, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rover_slam_tpu_torch  # noqa: F401  (fails outside the repo)
    if sys.argv[1:2] == ["--worker"]:
        worker_main(sys.argv[2], sys.argv[3])
        return
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    mark = Marks()

    log(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    attn_err, nn_err = phase_parity(dev)
    timing = phase_timing(dev)
    mark("build, parity, timing")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # Started after the kernels' timing, which has the card to itself.
        workers = Workers(tmp)
        try:
            scene_a = PathA(dev, n_frames=80)
            phase_lightglue(scene_a)
            paths = {"A": phase_path_a(scene_a)}
            del scene_a
            mark("lightglue, A")
            workers.poll()
            paths["B"] = phase_path_b(dev)
            paths["B kidnap"] = phase_path_b_kidnap(dev)
            paths["B lifecycle"] = phase_path_b_lifecycle(dev)
            mark("B")
            workers.poll()
            scene_c = PathA(dev, n_frames=160)
            paths["C"] = phase_path_c(scene_c)
            mark("C")
            workers.poll()
            paths["D"] = phase_path_d(scene_c)
            mark("D")
            workers.poll()
            scene_g = PathG(dev)
            paths["G pipeline=4"] = phase_path_g_pipelined(scene_g)
            mark("G pipeline=4")
            done = workers.join(timeout=1100.0 - (time.perf_counter() - t_start))
            mark("waiting for the workers")
        finally:
            workers.kill()
    # Alone on the card from here (see WORKER_GROUPS).
    paths["E run 1"], paths["E run 2"] = phase_path_e(scene_c)
    mark("E")
    paths["M"] = phase_path_m(scene_c, paths["E run 1"], dev)
    mark("M")
    paths["L"] = phase_path_l(scene_c, paths["E run 1"], dev)
    mark("L")
    del scene_c
    paths["G sync run 1"], paths["G sync run 2"] = phase_path_g_sync(scene_g)
    del scene_g
    mark("G sync")
    seconds = {"main": mark.seconds()}
    for group, res in done:
        seconds[f"worker {group}"] = res["seconds"]
        paths.update({k: {"launches": v} for k, v in res["launches"].items()})
    log("# seconds by phase:", json.dumps(seconds))
    launches = {k: sum(p["launches"][k] for p in paths.values())
                for k in ("attention", "nn", "pose_opt")}
    log("# launches by path:", json.dumps({k: p["launches"] for k, p in paths.items()}))

    ta, tn, tpo = timing["attention_B1"], timing["nn_512x512x64"], timing["pose_opt_2x6"]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "rover_slam_tpu_torch/csrc/flash_attention.cu",
         "replaces": "rover_slam_tpu/ops/pallas_attention.py:31",
         "launches": launches["attention"],
         "max_abs_err": attn_err, "ms": ta[0], "plain_ms": ta[1], "bound_ms": ta[3],
         "bound_by": ta[4], "library_ms": ta[2]},
        {"name": "nn_matcher", "route": "cuda",
         "source": "rover_slam_tpu_torch/csrc/nn_matcher.cu",
         "replaces": "rover_slam_tpu/ops/pallas_matcher.py:33",
         "launches": launches["nn"],
         "max_abs_err": nn_err, "ms": tn[0], "plain_ms": tn[1], "bound_ms": tn[3],
         "bound_by": tn[4], "library_ms": tn[2]},
        {"name": "pose_opt", "route": "cuda",
         "source": "rover_slam_tpu_torch/csrc/pose_opt.cu",
         "replaces": None,     # the JAX package's pose_optimization is one XLA program
         "launches": launches["pose_opt"],
         "max_abs_err": tpo[5], "ms": tpo[0], "plain_ms": tpo[1], "bound_ms": tpo[3],
         "bound_by": tpo[4], "library_ms": None},
    ]
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
