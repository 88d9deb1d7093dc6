"""Headline benchmark of the PyTorch / CUDA port: integrated end-to-end
monocular tracking fps on one GPU. The twin of bench.py.

    python3 bench_port.py        # needs a CUDA device; exits 1 without one

Prints ONE JSON line on stdout (progress goes to stderr) with bench.py's keys
and definitions: metric "mono_tracking_fps_per_chip", value (fps over the
timed frames), unit, vs_baseline = fps / 30, and under detail composition,
frames_timed, ate_cm, frac_frames_tracked, n_kf, n_loops, loop_events,
loop_diag, frame_ms, superpoint_ms, lightglue_ms and baseline. It adds
frames_tracked_ok (the share of frames logged OK, where frac_frames_tracked is
bench.py's share of logged poses that are finite), trajectory_digest,
stage_median_ms and device (the card's name, its power limit from nvidia-smi
and the device count).

The protocol is bench.py's: the ring photo world (1400 sprites, 17 px
patches, seed 0) at 480x640 and fx 458, 160 frames of orbit_trajectory (1.1
revolutions at 1/30 s), all rendered before the clock; SuperPoint (1024
keypoints, 256-D) and 9-layer LightGlue (threshold 0.1) from the shipped
rover_slam_tpu/assets/{superpoint,lightglue}_synth.npz, read as plain npz
(a missing file is an error: bench.py's random-weight branch is not ported);
LightGlue is the tracker's frame matcher; TrackerConfig(local_map_only,
kf_cull_every=0, min_init_matches=40, min_inliers_local_map=20), capacities
512 / 1024 / 16384, loop closing with LoopConfig(min_covis_weight=30),
pipeline=4; 40 warm-up frames, flush, precompile, 120 timed frames, flush.
superpoint_ms and lightglue_ms follow bench.py's time_it: 2 warm-up calls,
then 20 calls ended by one synchronize, LightGlue on one 1024-keypoint pair.

Where it differs from bench.py: every frame ends in a device synchronize, so
a frame's time is its latency (bench.py's JAX dispatch is asynchronous and
its frames end without waiting for the device); before the warm-up frames,
two frames run on a throw-away system (allocator pools, cuDNN and cuBLAS
plans).

The scene and the loop (PathA, run_path_c, loop_summary) are chip_smoke.py's
path E, which imports them from here: path E and this script run one copy of
the loop and give one trajectory digest.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

H, W, NK, D = 480, 640, 1024, 256
RELOC_L = 16384          # landmark table of the bench map (global relocalization)
LIGHTGLUE_LAYERS = 9
FX = 458.0
N_WARM, N_TIMED = 40, 120
BASELINE = "reference real-time claim = 30 fps camera on RTX 3080 (no published numbers)"


def log(*a):
    print(*a, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            f"nvidia-smi failed: {smi.stderr.strip()}")


def trajectory_digest(slam) -> str:
    """sha256 of the final trajectory's times and poses: two runs that agree
    to the bit give the same digest."""
    import hashlib
    h = hashlib.sha256()
    for a in slam.get_trajectory():
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def trajectory_quality(slam, R_gt, t_gt, times) -> dict:
    """bench.py's quality numbers: frac_frames_tracked, the share of logged
    poses whose rotation and centre are finite (0 with 10 poses or fewer);
    ate_cm, the RMSE in cm after a Horn alignment with scale over the finite
    poses associated by time with the ground truth, NaN with 10 pairs or
    fewer; and those pairs."""
    from rover_slam_tpu_torch.utils import trajectory
    est_t, est_R, est_tcw = slam.get_trajectory()
    out = {"ate_cm": float("nan"), "frac_frames_tracked": 0.0, "pairs": []}
    if len(est_t) <= 10:
        return out
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    fin = (np.isfinite(est_pos).all(axis=1)
           & np.isfinite(est_R.reshape(len(est_t), -1)).all(axis=1))
    out["frac_frames_tracked"] = float(fin.mean())
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times) if fin[i]]
    out["pairs"] = pairs
    if len(pairs) > 10:
        e = np.stack([est_pos[i] for i, _ in pairs])
        g = np.stack([gt_pos[j] for _, j in pairs])
        out["ate_cm"] = float(trajectory.ate_rmse(e, g, with_scale=True)[0] * 100.0)
    return out


def _ate_cm(slam, R_gt, t_gt, times):
    """(ate_cm, pairs) of trajectory_quality."""
    q = trajectory_quality(slam, R_gt, t_gt, times)
    return q["ate_cm"], q["pairs"]


def _reset_launches():
    from rover_slam_tpu_torch.utils import profiling
    profiling.reset_counters()


def _launches() -> dict:
    from rover_slam_tpu_torch.utils import profiling as P
    return {"attention": P.counter("attention_launches"), "nn": P.counter("nn_launches"),
            "pose_opt": P.counter("pose_opt_launches"),
            "attention_backward": P.counter("backward_recomputes"),
            "attention_by_batch": P.counter_by("launches_by_batch"),
            "nn_by_shape": P.counter_by("launches_by_shape")}


def bench_camera(hw=(H, W)) -> np.ndarray:
    """bench.py's pinhole camera [8] at image size hw; a narrower image
    keeps the field of view (fx scales with the width)."""
    h, w = hw
    fx = FX * w / W
    return np.asarray([fx, fx, w / 2.0, h / 2.0, 0, 0, 0, 0], np.float32)


def bench_scene(n_frames: int = N_WARM + N_TIMED, hw=(H, W)):
    """bench.py's scene without its images: (cam [8], the ring photo world,
    (R_cw, t_cw, times)), cut to n_frames at the bench's per-frame motion
    (1.1 revolutions over 160 frames). A narrower image keeps the field of
    view: fx scales with the width."""
    from rover_slam_tpu_torch.utils import synthetic
    h, w = hw
    cam = bench_camera(hw)
    world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=(h, w),
                                       layout="ring", ring_orbit_radius=5.0)
    gt = synthetic.orbit_trajectory(n_frames=n_frames, orbit_radius=5.0,
                                    revs=1.1 * n_frames / 160.0, dt=1.0 / 30.0)
    return cam, world._replace(cam_params=cam), gt


class PathA:
    """The bench scene (bench.py's configuration; loop closing is an option
    of new_slam), cut to n_frames at the bench's per-frame motion: the
    rendered frames, the shipped-weight front end, and a factory for fresh
    SLAM systems. hw, n_kpts, layers and tables cut the widths (the CPU
    tests run it small); the defaults are the bench's."""
    K, L = 512, RELOC_L

    def __init__(self, dev, n_frames: int, gt=None, hw=(H, W), n_kpts: int = NK,
                 layers: int = LIGHTGLUE_LAYERS, tables=None):
        """gt: (R_cw, t_cw, times) of the frames; None = the bench orbit.
        tables: the map's (keyframe, landmark) capacities; None = (512,
        16384). Its keypoint capacity is n_kpts."""
        from rover_slam_tpu_torch.models.lightglue import (LightGlueFrameMatcher,
                                                           LightGlueMatcher)
        from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor
        from rover_slam_tpu_torch.models.weights import load_flat_npz
        from rover_slam_tpu_torch.slam import tracking as T

        self.dev = dev
        self.hw, self.n_kpts = tuple(hw), n_kpts
        if tables is not None:
            self.K, self.L = tables
        self.cam, self.world, orbit = bench_scene(n_frames, hw)
        self.R_gt, self.t_gt, self.times = gt if gt is not None else orbit
        t_r = time.perf_counter()
        self.imgs = [self.render(self.R_gt[i], self.t_gt[i]) for i in range(n_frames)]
        log(f"# scene: rendered {n_frames} frames in {time.perf_counter() - t_r:.1f} s")
        assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "rover_slam_tpu", "assets")
        sp = load_flat_npz(os.path.join(assets, "superpoint_synth.npz"))
        lg = load_flat_npz(os.path.join(assets, "lightglue_synth.npz"))
        self.ext = SuperPointExtractor(params=sp, max_keypoints=n_kpts, device=dev)
        self.matcher = LightGlueFrameMatcher(
            LightGlueMatcher(params=lg, num_layers=layers, threshold=0.1, device=dev),
            self.hw)
        self.cfg = T.TrackerConfig(image_hw=self.hw, local_map_only=True, kf_cull_every=0,
                                   min_init_matches=40, min_inliers_local_map=20)
        self.camt = torch.as_tensor(self.cam, device=dev)

    def render(self, R, t):
        from rover_slam_tpu_torch.utils import synthetic
        img = synthetic.render_photo_frame(self.world, R, t).astype(np.float32) / 255.0
        return torch.from_numpy(img)[None].to(self.dev)

    def new_slam(self, pipeline=0, loop=False, mesh=None):
        """loop=True: bench.py's loop closer, LoopConfig(min_covis_weight=30);
        mesh: its global BA sharded over the mesh (chip_smoke.py path L2)."""
        from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
        from rover_slam_tpu_torch.slam.system import MonocularSLAM
        return MonocularSLAM(self.cam, config=self.cfg,
                             map_capacity=(self.K, self.n_kpts, self.L),
                             desc_dim=D, pipeline=pipeline, enable_loop_closing=loop,
                             loop_config=LoopConfig(min_covis_weight=30) if loop else None,
                             matcher=self.matcher, mesh=mesh, device=self.dev)

    def step_image(self, slam, img, t):
        """One frame through the user's entry points: SuperPoint, unproject,
        track_frame (LightGlue runs inside as the matcher), then a device
        synchronize (the frame's latency is what a user feels)."""
        from rover_slam_tpu_torch.geometry import cameras
        out = self.ext(img)
        kpts = out["keypoints"][0]
        rays = cameras.unproject(cameras.PINHOLE, self.camt, kpts)
        info = slam.track_frame(kpts, rays, out["descriptors"][0], out["valid"][0], float(t))
        _sync(self.dev)
        return info

    def step(self, slam, i):
        return self.step_image(slam, self.imgs[i], self.times[i])

    def warm_up(self, n: int = 2):
        """Allocator, cuDNN and cuBLAS plans, on a throw-away system."""
        warm = self.new_slam()
        for i in range(n):
            self.step(warm, i)


class _SyncCount:
    n = None


@contextlib.contextmanager
def counting_syncs(dev, on: bool = True):
    """Counts the implicit host syncs of the block, as
    torch.cuda.set_sync_debug_mode("warn") reports them: the yielded
    object's n, set when the block ends (None on the CPU or with on=False)."""
    box = _SyncCount()
    if not (on and dev.type == "cuda"):
        yield box
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(0)
    box.n = sum("synchroniz" in str(w.message) for w in caught)


def _tracked(slam) -> int:
    """Frames logged as OK (in pipeline mode the state at each frame's finish)."""
    from rover_slam_tpu_torch.slam import tracking as T
    return sum(e[3] == T.OK for e in slam.trajectory)


def run_path_c(scene, count_syncs: bool, n_warm: int = N_WARM, pipeline: int = 4,
               loop: bool = False, name: str = "C", mesh=None, keep_slam: bool = False):
    """bench.py's loop over the scene: a fresh pipeline=4 system, 40 warm-up
    frames, flush, precompile, the timed frames, flush. fps and frame times
    over the timed frames; with count_syncs, the implicit host syncs of the
    timed frames counted by torch.cuda.set_sync_debug_mode("warn") (the
    deferred flags reads, one event wait per frame, are not among them).
    loop=True is bench.py with its loop closer (chip_smoke.py path E): the
    result adds flush_ms, the loop events, bench.py's loop_diag, the frame
    that fired the first loop with its ms and the frames that ran a deferred
    global BA chunk with theirs. mesh: the system's mesh (path L2). Keys that
    start with "_" are kept out of the log line: the raw per-frame poses
    logged before the first loop fired (and with keep_slam the system)."""
    n_frames = len(scene.imgs)
    scene.warm_up()
    slam = scene.new_slam(pipeline=pipeline, loop=loop, mesh=mesh)
    lc = slam.loop_closer
    n_traj_before, n_loops_after, pending_after = [], [], []

    def step(i):
        n_traj_before.append(len(slam.trajectory))
        scene.step(slam, i)
        n_loops_after.append(len(slam.loop_events))
        pending_after.append(lc._gba_pending if lc is not None else 0)

    _reset_launches()
    for i in range(n_warm):
        step(i)
    slam.flush()
    slam.precompile()
    frame_ms = []
    with counting_syncs(scene.dev, on=count_syncs) as syncs:
        t0 = time.perf_counter()
        for i in range(n_warm, n_frames):
            t1 = time.perf_counter()
            step(i)
            frame_ms.append((time.perf_counter() - t1) * 1000.0)
        t_fl = time.perf_counter()
        slam.flush()
        _sync(scene.dev)
        flush_ms = (time.perf_counter() - t_fl) * 1000.0
        wall = time.perf_counter() - t0
    launches = _launches()
    frame_ms = np.asarray(frame_ms)
    n_timed = n_frames - n_warm
    n_tracked = _tracked(slam)
    ate_cm, _ = _ate_cm(slam, scene.R_gt, scene.t_gt, scene.times)
    res = {"frames": n_frames, "frames_timed": n_timed, "fps": n_timed / wall,
           "frame_ms_median": float(np.median(frame_ms)),
           "frame_ms_mean": float(frame_ms.mean()),
           "frame_ms_p95": float(np.percentile(frame_ms, 95)),
           "frame_ms_max": float(frame_ms.max()), "flush_ms": flush_ms,
           "ate_cm": ate_cm, "frac_tracked": n_tracked / n_frames, "frames_tracked": n_tracked,
           "n_kf": slam.n_kf, "n_lm": int(slam.state.n_lm),
           "host_syncs_per_frame": syncs.n / n_timed if count_syncs else None,
           "launches": launches, "trajectory_digest": trajectory_digest(slam),
           "stage_median_ms": {k: v["median_ms"] for k, v in slam.timers.summary().items()}}
    if loop:
        res.update(loop_summary(slam))
        fire = next((i for i, n in enumerate(n_loops_after) if n > 0), None)
        chunks = [i for i in range(1, n_frames)
                  if fire is not None and i > fire and pending_after[i] < pending_after[i - 1]]
        res.update({"fire_frame": fire,
                    "fire_frame_ms": (float(frame_ms[fire - n_warm])
                                      if fire is not None and fire >= n_warm else None),
                    "gba_chunk_frames": chunks,
                    "gba_chunk_ms": [float(frame_ms[i - n_warm]) for i in chunks if i >= n_warm]})
        n_before = n_traj_before[fire] if fire is not None else len(slam.trajectory)
        res["_poses_before_fire"] = [
            (e[0], e[3], torch.as_tensor(e[1]).cpu().numpy(), torch.as_tensor(e[2]).cpu().numpy())
            for e in slam.trajectory[:n_before]]
    if keep_slam:
        res["_slam"] = slam
    log(f"# path {name}:", json.dumps({k: v for k, v in res.items() if not k.startswith("_")}))
    return res


def loop_summary(slam) -> dict:
    """n_loops, the loop events and bench.py's loop_diag (retrieval gates,
    verification dispatches, best seed and guided inlier counts), unrounded."""
    lc = slam.loop_closer
    events = [dict(kf=kf, **{k: v for k, v in info.items() if k != "loop"})
              for kf, info in slam.loop_events]
    diag = {"n_queries": len(lc.score_log),
            "n_dispatched": sum(1 for r in lc.score_log if r[3]),
            "max_retrieval_score": max((r[1] for r in lc.score_log), default=0.0),
            "max_minscore_gate": max((r[2] for r in lc.score_log), default=0.0),
            "best_seed_inliers": max((max(r[4]) for r in lc.cand_log if r[4]), default=0),
            "best_proj_inliers": max((r[6] for r in lc.cand_log), default=0),
            "n_hyp_checks": len(lc.hyp_log)}
    return {"n_loops": len(slam.loop_events), "loop_events": events, "loop_diag": diag}


def bench_loop_events(slam) -> list:
    """The loop events in bench.py's form."""
    return [{"kf": int(kf), "candidate": int(li.get("candidate", -1)),
             "n_inliers": int(li.get("n_inliers", 0)), "merge": bool(li.get("merge", False)),
             "n_fused": int(li.get("n_fused", 0))} for kf, li in slam.loop_events]


def time_it(fn, dev, warmup: int = 2, reps: int = 20) -> float:
    """bench.py's queued timing, in seconds a call: `warmup` calls each
    ended by a synchronize, then `reps` calls ended by one synchronize."""
    for _ in range(warmup):
        fn()
        _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def clone_state(st):
    """A MapState whose tensors are copies of st's (the profiling twins run
    every timed call on its own)."""
    from rover_slam_tpu_torch.map import map_state as ms
    return st.replace(**{f: getattr(st, f).clone() for f in ms.FIELDS})


def output_digest(out) -> str:
    """sha256 of a call's outputs (tensors, numbers and nested tuples of
    them), their dtypes and shapes included: two calls that agree to the bit
    give the same digest. Reads the outputs to the host."""
    import hashlib
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous()
            h.update(f"{x.dtype}{tuple(x.shape)}".encode())
            h.update(x.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())
    walk(out)
    return h.hexdigest()[:16]


def profile_call(fn, dev, warmup: int = 2, reps: int = 10, minus_ms: float = 0.0) -> dict:
    """One line of the profiling twins: fn() runs a stage once. Returns
    ms, the time a call by bench.py's time_it protocol (warmup calls, then
    reps calls ended by one synchronize) less minus_ms (the state clone each
    call makes); b1, b2 and b1_by_batch, the kernel launches of one more
    call, counted apart from the timed ones, with syncs its implicit host
    syncs (None on the CPU); digests, the outputs' digest of the warm-up
    calls and of the counted one; out, the counted call's outputs."""
    digests = [output_digest(fn()) for _ in range(warmup)]
    before = _launches()
    with counting_syncs(dev) as syncs:
        out = fn()
        _sync(dev)
    after = _launches()
    digests.append(output_digest(out))
    ms = time_it(fn, dev, warmup=0, reps=reps) * 1000.0 - minus_ms
    by_batch = {b: n - before["attention_by_batch"].get(b, 0)
                for b, n in after["attention_by_batch"].items()}
    return {"ms": ms, "b1": after["attention"] - before["attention"],
            "b2": after["nn"] - before["nn"], "syncs": syncs.n,
            "b1_by_batch": {b: n for b, n in by_batch.items() if n},
            "digests": digests, "out": out}


def counts(r: dict) -> str:
    """The launches and syncs the twins print after each line."""
    return f"b1={r['b1']} b2={r['b2']} syncs={r['syncs']}"


def device_info(dev) -> dict:
    """The device a result ran on: the card's name, its power limit in W
    (nvidia-smi) and the device count; the CPU when the caller asked for it."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    line = card()
    try:
        limit = float(line.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        limit = None
    return {"name": torch.cuda.get_device_name(dev), "power_limit_w": limit,
            "nvidia_smi": line, "count": torch.cuda.device_count()}


def run(device=None, n_frames: int = N_WARM + N_TIMED, n_warm: int = N_WARM, hw=(H, W),
        n_kpts: int = NK, layers: int = LIGHTGLUE_LAYERS, tables=None,
        reps: int = 20) -> dict:
    """bench.py's protocol on the port; the result line as a dict. device
    None is the card; the other arguments cut the widths and the frames."""
    from rover_slam_tpu_torch.models.lightglue import normalize_keypoints
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    scene = PathA(dev, n_frames, hw=hw, n_kpts=n_kpts, layers=layers, tables=tables)
    r = run_path_c(scene, count_syncs=False, n_warm=n_warm, loop=True, name="E",
                   keep_slam=True)
    slam = r["_slam"]
    q = trajectory_quality(slam, scene.R_gt, scene.t_gt, scene.times)

    img0 = scene.imgs[0]
    t_sp = time_it(lambda: scene.ext(img0), dev, reps=reps)
    out0 = scene.ext(img0)
    k = normalize_keypoints(out0["keypoints"], scene.hw)
    lg = scene.matcher.matcher
    t_lg = time_it(lambda: lg(k, out0["descriptors"], out0["valid"],
                              k, out0["descriptors"], out0["valid"]), dev, reps=reps)
    fps = r["fps"]
    return {
        "metric": "mono_tracking_fps_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 30.0,
        "detail": {
            "composition": (
                f"ONE integrated loop: image -> SuperPoint({n_kpts}kpt,{D}D, in-env-trained) "
                f"-> LightGlue({layers}L, in-env-trained, driving tracker+loop closer; "
                f"attention on kernel B1) -> tracking and mapping (pipeline=4 product path) "
                f"+ loop closing (NN seeds on kernel B2); every frame ends in a device "
                f"synchronize"),
            "frames_timed": r["frames_timed"],
            "ate_cm": q["ate_cm"],
            "frac_frames_tracked": q["frac_frames_tracked"],
            "frames_tracked_ok": r["frac_tracked"],
            "n_kf": int(slam.n_kf),
            "n_loops": r["n_loops"],
            "loop_events": bench_loop_events(slam),
            "loop_diag": r["loop_diag"],
            "frame_ms": {"median": r["frame_ms_median"], "mean": r["frame_ms_mean"],
                         "p95": r["frame_ms_p95"], "max": r["frame_ms_max"],
                         "flush_ms": r["flush_ms"]},
            "superpoint_ms": t_sp * 1000.0,
            "lightglue_ms": t_lg * 1000.0,
            "baseline": BASELINE,
            "trajectory_digest": r["trajectory_digest"],
            "stage_median_ms": r["stage_median_ms"],
            "launches": {k: r["launches"][k] for k in ("attention", "nn")},
            "device": device_info(dev),
        },
    }


def main(device=None, **cut) -> int:
    """Run bench.py's protocol and print its one JSON line. Without a CUDA
    device it fails unless the caller asks for another device (the CPU
    tests do, with a cut size)."""
    if device is None and not torch.cuda.is_available():
        print("bench_port.py: no CUDA device", file=sys.stderr)
        return 1
    with contextlib.redirect_stdout(sys.stderr):
        res = run(device, **cut)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
