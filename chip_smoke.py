"""Chip smoke test of the PyTorch / CUDA port (rover_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. build   — nvcc builds every CUDA kernel of the port from csrc/.
  2. parity  — each kernel against its plain PyTorch version on the card.
  3. timing  — each kernel at the main path's shapes beside its bound, its
               plain version and a library call that computes the same thing.
  4. path A  — the bench scene at full width: 480x640 images -> SuperPoint
               (1024 keypoints, 256-D, shipped weights) -> LightGlue (9
               layers, shipped weights) as the frame matcher -> monocular
               tracking and mapping (capacities 512/1024/16384).
  5. path B  — the package's default configuration (mutual-NN matching) on
               the synthetic oracle world; ATE must stay under 3 cm.
Then one JSON line of kernels, the card's name and power limit, and a last
line {"ok": true, "device": {...}}. Needs a CUDA device; never imports JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

H, W, NK, D = 480, 640, 1024, 256
LIGHTGLUE_LAYERS = 9
# Published H100 SXM peaks (bf16 dense tensor rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
ATTN_TOL = 0.02          # bf16 attention vs plain (tests/test_pallas_attention.py)
NN_VALUE_TOL = 3e-2      # best / second-best d^2 (tests/test_pallas_matcher.py)


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def phase_build():
    from rover_slam_tpu_torch.ops import _build
    t0 = time.perf_counter()
    took = _build.build()
    log(f"# build: {time.perf_counter() - t0:.1f} s wall, per source {took}")


def attention_inputs(g, B, N, dev, Hh=4, Dh=64):
    q, k, v = (torch.randn(B, N, Hh, Dh, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    mask = (torch.rand(B, N, generator=g) > 0.2).to(dev)
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


def phase_parity(dev):
    from rover_slam_tpu_torch.ops import flash_attention as fa, nn_matcher as nm
    g = torch.Generator().manual_seed(0)
    attn_err = 0.0
    for B in (1, 2):
        for N in (512, 1024, 1280):
            q, k, v, mask = attention_inputs(g, B, N, dev)
            if B == 2:
                mask[1] = False          # one batch row whose kv is all masked
            out = fa.masked_attention(q, k, v, mask)
            torch.cuda.synchronize()
            ref = fa.masked_attention_plain(q, k, v, mask)
            err = float((out.float() - ref.float()).abs().max())
            log(f"# parity attention B={B} N={N}: max abs err {err:.3g}")
            if not err < ATTN_TOL:
                raise AssertionError(f"attention B={B} N={N}: err {err} >= {ATTN_TOL}")
            if B == 2:
                # All-masked kv: the mean of v over the real Nk.
                mean_v = v[1].float().mean(dim=0, keepdim=True).expand(N, -1, -1)
                err_m = float((out[1].float() - mean_v).abs().max())
                err_p = float((out[1].float() - ref[1].float()).abs().max())
                log(f"# parity attention all-masked row: vs mean(v) {err_m:.3g}, "
                    f"vs plain {err_p:.3g}")
                if not (err_m < ATTN_TOL and err_p < ATTN_TOL):
                    raise AssertionError("attention all-masked row disagrees")
            attn_err = max(attn_err, err)
    nn_err = 0.0
    # Path A's SuperPoint size, path B's synthetic size, and a ragged one.
    for (N0, N1, Dd) in ((NK, NK, D), (512, 512, 64), (200, 180, 64)):
        d0, v0, d1, v1 = nn_inputs(g, N0, N1, Dd, dev)
        best, idx, second = nm.nn_reduce(d0, d1, v1)
        torch.cuda.synchronize()
        best_p, idx_p, second_p = nm.nn_reduce_plain(d0, d1, v1)
        e_b = float((best - best_p).abs().max())
        e_s = float((second - second_p).abs().max())
        agree_idx = float((idx == idx_p).float().mean())
        m, _ = nm.mutual_nn_match(d0, v0, d1, v1, ratio=0.8)
        launches = nm.nn_launches
        m_p, _ = nm.mutual_gate(nm.nn_reduce_plain(d0, d1, v1),
                                nm.nn_reduce_plain(d1, d0, v0), v0, v1, ratio=0.8)
        agree = float((m == m_p).float().mean())
        both = (m >= 0) & (m_p >= 0)
        agree_both = float((m[both] == m_p[both]).float().mean()) if bool(both.any()) else 1.0
        log(f"# parity nn {N0}x{N1}x{Dd}: best err {e_b:.3g}, second err {e_s:.3g}, "
            f"argmin agree {agree_idx:.4f}, matches agree {agree:.4f}, "
            f"on pairs matched by both {agree_both:.4f} (kernel launches {launches})")
        if not (e_b < NN_VALUE_TOL and e_s < NN_VALUE_TOL and agree_idx > 0.95
                and agree > 0.95 and agree_both > 0.98):
            raise AssertionError(f"nn matcher {N0}x{N1}x{Dd} disagrees with plain")
        nn_err = max(nn_err, e_b, e_s)
    return attn_err, nn_err


def phase_timing(dev):
    from rover_slam_tpu_torch.ops import flash_attention as fa, nn_matcher as nm
    g = torch.Generator().manual_seed(1)
    rows = {}
    saved = (fa.attention_launches, nm.nn_launches)
    for B in (1, 2):
        q, k, v, mask = attention_inputs(g, B, NK, dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        amask = mask[:, None, None, :]
        t = cuda_time_ms(lambda: fa.masked_attention(q, k, v, mask))
        tp = cuda_time_ms(lambda: fa.masked_attention_plain(q, k, v, mask))
        tl = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask))
        Hh, Dh = q.shape[2], q.shape[3]
        n_bytes = 4 * B * NK * Hh * Dh * 2 + B * NK
        n_flops = 4.0 * B * Hh * NK * NK * Dh
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"# timing attention B={B} N={NK} H={Hh} Dh={Dh}: kernel {t:.4f} ms, "
            f"plain {tp:.4f} ms, sdpa {tl:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows[f"attention_B{B}"] = (t, tp, tl, bnd, by)
    for (N0, N1, Dd) in ((512, 512, 64), (NK, NK, D)):
        d0, _, d1, v1 = nn_inputs(g, N0, N1, Dd, dev)
        t = cuda_time_ms(lambda: nm.nn_reduce(d0, d1, v1))
        tp = cuda_time_ms(lambda: nm.nn_reduce_plain(d0, d1, v1))
        tl = cuda_time_ms(lambda: torch.cdist(d0, d1).topk(2, dim=1, largest=False))
        n_bytes = (N0 + N1) * Dd * 4 + N1 + 3 * N0 * 4
        n_flops = 2.0 * N0 * N1 * Dd
        bnd, by = bound_ms(n_bytes, n_flops)
        log(f"# timing nn {N0}x{N1}x{Dd}: kernel {t:.4f} ms, plain {tp:.4f} ms, "
            f"cdist+topk {tl:.4f} ms, bound {bnd:.5f} ms ({by})")
        rows[f"nn_{N0}x{N1}x{Dd}"] = (t, tp, tl, bnd, by)
    fa.attention_launches, nm.nn_launches = saved
    return rows


# ---------------------------------------------------------------------------
def _ate_cm(slam, R_gt, t_gt, times):
    from rover_slam_tpu_torch.utils import trajectory
    est_t, est_R, est_tcw = slam.get_trajectory()
    if len(est_t) == 0:
        return float("nan"), []
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    fin = np.isfinite(est_pos).all(axis=1)
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times) if fin[i]]
    if len(pairs) < 3:
        return float("nan"), pairs
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    return trajectory.ate_rmse(e, g, with_scale=True)[0] * 100.0, pairs


class PathA:
    """The bench scene at full width (bench.py's configuration with loop
    closing off and the synchronous tracker), cut to n_frames at the bench's
    per-frame motion: the scene, the shipped-weight front end, and a factory
    for fresh SLAM systems."""
    K, L = 512, 16384

    def __init__(self, dev, n_frames: int):
        from rover_slam_tpu_torch.models.lightglue import (LightGlueFrameMatcher,
                                                           LightGlueMatcher)
        from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor
        from rover_slam_tpu_torch.models.weights import load_flat_npz
        from rover_slam_tpu_torch.slam import tracking as T
        from rover_slam_tpu_torch.utils import synthetic

        self.dev = dev
        fx = 458.0
        self.cam = np.asarray([fx, fx, W / 2.0, H / 2.0, 0, 0, 0, 0], np.float32)
        world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0,
                                           image_hw=(H, W), layout="ring",
                                           ring_orbit_radius=5.0)
        world = world._replace(cam_params=self.cam)
        # bench.py orbits 1.1 revolutions over 160 frames; keep its per-frame
        # motion over the cut sequence.
        self.R_gt, self.t_gt, self.times = synthetic.orbit_trajectory(
            n_frames=n_frames, orbit_radius=5.0, revs=1.1 * n_frames / 160.0,
            dt=1.0 / 30.0)
        t_r = time.perf_counter()
        self.imgs = [torch.from_numpy(synthetic.render_photo_frame(
            world, self.R_gt[i], self.t_gt[i]).astype(np.float32) / 255.0)[None].to(dev)
            for i in range(n_frames)]
        log(f"# path A: rendered {n_frames} frames in {time.perf_counter() - t_r:.1f} s")
        assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "rover_slam_tpu", "assets")
        sp = load_flat_npz(os.path.join(assets, "superpoint_synth.npz"))
        lg = load_flat_npz(os.path.join(assets, "lightglue_synth.npz"))
        self.ext = SuperPointExtractor(params=sp, max_keypoints=NK, device=dev)
        self.matcher = LightGlueFrameMatcher(
            LightGlueMatcher(params=lg, num_layers=LIGHTGLUE_LAYERS, threshold=0.1,
                             device=dev), (H, W))
        self.cfg = T.TrackerConfig(image_hw=(H, W), local_map_only=True, kf_cull_every=0,
                                   min_init_matches=40, min_inliers_local_map=20)
        self.camt = torch.as_tensor(self.cam, device=dev)

    def new_slam(self):
        from rover_slam_tpu_torch.slam.system import MonocularSLAM
        return MonocularSLAM(self.cam, config=self.cfg, map_capacity=(self.K, NK, self.L),
                             desc_dim=D, pipeline=0, enable_loop_closing=False,
                             matcher=self.matcher, device=self.dev)

    def step(self, slam, i):
        """One frame through the user's entry points: SuperPoint, unproject,
        track_frame (LightGlue runs inside as the matcher)."""
        from rover_slam_tpu_torch.geometry import cameras
        out = self.ext(self.imgs[i])
        kpts = out["keypoints"][0]
        rays = cameras.unproject(cameras.PINHOLE, self.camt, kpts)
        info = slam.track_frame(kpts, rays, out["descriptors"][0], out["valid"][0],
                                float(self.times[i]))
        _sync(self.dev)
        return info

    def warm_up(self, n: int = 2):
        """Allocator, cuDNN and cuBLAS plans, on a throw-away system."""
        warm = self.new_slam()
        for i in range(n):
            self.step(warm, i)


def phase_path_a(dev, n_frames: int = 80):
    from rover_slam_tpu_torch.ops import flash_attention as fa, nn_matcher as nm
    from rover_slam_tpu_torch.slam import tracking as T

    scene = PathA(dev, n_frames)
    scene.warm_up()
    slam = scene.new_slam()
    R_gt, t_gt, times = scene.R_gt, scene.t_gt, scene.times
    L = scene.L

    fa.attention_launches = 0
    nm.nn_launches = 0
    frame_ms, states = [], []
    t0 = time.perf_counter()
    for i in range(n_frames):
        t1 = time.perf_counter()
        states.append(scene.step(slam, i)["state"])
        frame_ms.append((time.perf_counter() - t1) * 1000.0)
    wall = time.perf_counter() - t0
    launches = {"attention": fa.attention_launches, "nn": nm.nn_launches}
    frame_ms = np.asarray(frame_ms)
    n_tracked = sum(s == T.OK for s in states)
    ate_cm, pairs = _ate_cm(slam, R_gt, t_gt, times)
    n_lm = int(slam.state.n_lm)
    res = {"frames": n_frames, "fps": n_frames / wall,
           "frame_ms_median": float(np.median(frame_ms)),
           "frame_ms_p95": float(np.percentile(frame_ms, 95)),
           "frame_ms_max": float(frame_ms.max()),
           "ate_cm": ate_cm, "frac_tracked": n_tracked / n_frames,
           "n_kf": slam.n_kf, "n_lm": n_lm, "launches": launches,
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()}}
    log("# path A:", json.dumps(res))
    if not res["frac_tracked"] >= 0.9:
        raise AssertionError(f"path A tracked only {res['frac_tracked']:.2f} of frames")
    if not launches["attention"] >= 36 * n_tracked:
        raise AssertionError(f"path A: {launches['attention']} attention launches "
                             f"for {n_tracked} tracked frames")
    if not n_lm < L - (3 * NK + 64):
        raise AssertionError(f"path A: n_lm {n_lm} reached the compaction threshold")
    if not math.isfinite(ate_cm):
        raise AssertionError("path A: trajectory not finite")
    return res


def phase_path_b(dev):
    """The package default (matcher=None -> mutual-NN on kernel B2) on the
    synthetic oracle world of tests/test_e2e_mono.py."""
    from rover_slam_tpu_torch.ops import flash_attention as fa, nn_matcher as nm
    from rover_slam_tpu_torch.slam import tracking as T
    from rover_slam_tpu_torch.slam.system import MonocularSLAM
    from rover_slam_tpu_torch.utils import synthetic
    world = synthetic.make_world(n_landmarks=3000, desc_dim=64, seed=0)
    R_gt, t_gt, times = synthetic.forward_trajectory(n_frames=40, dt=0.1, speed=0.6,
                                                     yaw_rate=0.04)
    frames = synthetic.render_sequence(world, R_gt, t_gt, times, n_kpts=512,
                                       pix_noise=0.4, desc_noise=0.05)
    slam = MonocularSLAM(world.cam_params, map_capacity=(64, 512, 8192), desc_dim=64,
                         device=dev)
    fa.attention_launches = 0
    nm.nn_launches = 0
    t0 = time.perf_counter()
    states = [slam.track_frame(f.kpts, f.rays, f.desc, f.valid, f.time)["state"]
              for f in frames]
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {"attention": fa.attention_launches, "nn": nm.nn_launches}
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import rover_slam_tpu_torch  # noqa: F401  (fails outside the repo)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()
    attn_err, nn_err = phase_parity(dev)
    timing = phase_timing(dev)
    path_a = phase_path_a(dev)
    path_b = phase_path_b(dev)

    ta, tn = timing["attention_B1"], timing["nn_512x512x64"]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "rover_slam_tpu_torch/csrc/flash_attention.cu",
         "replaces": "rover_slam_tpu/ops/pallas_attention.py:31",
         "launches": path_a["launches"]["attention"] + path_b["launches"]["attention"],
         "max_abs_err": attn_err, "ms": ta[0], "plain_ms": ta[1], "bound_ms": ta[3],
         "bound_by": ta[4], "library_ms": ta[2]},
        {"name": "nn_matcher", "route": "cuda",
         "source": "rover_slam_tpu_torch/csrc/nn_matcher.cu",
         "replaces": "rover_slam_tpu/ops/pallas_matcher.py:33",
         "launches": path_a["launches"]["nn"] + path_b["launches"]["nn"],
         "max_abs_err": nn_err, "ms": tn[0], "plain_ms": tn[1], "bound_ms": tn[3],
         "bound_by": tn[4], "library_ms": tn[2]},
    ]
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
