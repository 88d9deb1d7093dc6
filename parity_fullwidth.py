"""The JAX package and the PyTorch port, frame by frame, on the bench scene at
full width, both on the CPU.

    python3 parity_fullwidth.py [--frames 80] [--pipeline K] [--loop] [--inertial]
                                [--out rows.json]
    python3 parity_fullwidth.py --app [--sensor stereo-inertial] [--frames 120] [--tree DIR]
                                [--out summary.json]
    python3 parity_fullwidth.py --stereo [--frames 160] [--out rows.json]
    python3 parity_fullwidth.py --fisheye-stereo-inertial [--out summary.json]

The scene is chip_smoke.py's path A: the ring photo world (1400 sprites),
480x640 frames rendered once with numpy at the bench's per-frame motion
(revs = 1.1 * frames / 160), capacities 512 / 1024 / 16384, 256-D
descriptors. Each frame goes through two systems, each with its own shipped
SuperPoint (1024 keypoints) and 9-layer LightGlue as the frame matcher,
loop closing off, bench.py's TrackerConfig, pipeline=0 (or --pipeline K,
with bench.py's flush after 40 frames: chip_smoke.py's path C at
--frames 160; with --loop, loop closing on as bench.py configures it,
LoopConfig(min_covis_weight=30): chip_smoke.py's path E at --pipeline 4
--frames 160):
  jax    rover_slam_tpu's MonocularSLAM (LightGlue's attention on the XLA
         path, which rounds the scores and the softmax weights to bf16 at
         1024 keypoints);
  torch  rover_slam_tpu_torch's MonocularSLAM(device="cpu"), whose
         LightGlue takes masked_attention_plain on the CPU (the same
         rounding).
One line per frame (in pipeline mode the state, inliers and pose are those
of the frame finished then, K frames back): keypoints both extractors found (same pixel), LightGlue
match counts, agreement of the frame matches over the previous frame's
keypoints matched by either side (a match agrees when both sides pick the
same pixel in the current frame), tracking states, n_inliers, keyframe
counts, and the distance between the two systems' camera centres (each in
its own map frame: first keyframe at the origin, median depth 1). At the end
each system's ATE (scale-aligned Horn, evaluate_ate_scale's protocol), and
with --loop each side's fired loops (query keyframe, candidate, inliers,
scale, fused landmarks) and the loop closer's diagnostics (bench.py's
loop_diag). With --inertial both sides are MonocularInertialSLAMs on
chip_smoke.py's path G: the trajectory is orbit_with_imu (radius 5 m, 1.1
revolutions per 160 frames at 1/30 s, IMU at 200 Hz, camera = body, the IMU
calibration of tests/test_e2e_inertial.py), tinit_s=2.0, loop closing on
with LoopConfig(min_covis_weight=30, fix_scale=True); each frame's IMU
samples are fed before it. The summary adds the frame at which each side's
IMU initialized, the scale and gravity of each inertial-only solve, the final
biases against the simulated ones, and the metric ATE (Horn without scale)
beside the scale-aligned one, both over the frames after the init. A
comparison script, not part of the port: it imports both packages. With
--app both packages' EuRoC apps run on chip_smoke.py's path H tree instead
(run_apps; with --sensor stereo-inertial on path J1's stereo tree); with
--stereo both packages' StereoSLAMs run on chip_smoke.py's path I scene
(run_stereo); with --fisheye-stereo-inertial both packages'
FisheyeStereoInertialSLAMs run on path J2's second scene (run_fisheye_si).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

H, W, NK, D = 480, 640, 1024, 256
CAPACITY = (512, NK, 16384)
PIX = 0.5          # two keypoints are the same when closer than this (px)


class Recorder:
    """Wraps a frame matcher and keeps the frame-to-frame call's inputs and
    matches (triangulation's batched calls pass through unrecorded)."""

    def __init__(self, matcher):
        self.matcher = matcher
        self.last = None

    def __call__(self, kpts0, desc0, valid0, kpts1, desc1, valid1):
        m = self.matcher(kpts0, desc0, valid0, kpts1, desc1, valid1)
        self.last = (np.asarray(kpts0), np.asarray(kpts1), np.asarray(m))
        return m

    def match_batch(self, *args):
        return self.matcher.match_batch(*args)


def _same_pixel(a, b):
    """For each row of a [n, 2], the index of the row of b at the same pixel
    (within PIX), else -1."""
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    j = d.argmin(axis=1)
    return np.where(d[np.arange(len(a)), j] < PIX, j, -1)


def match_agreement(rec_j, rec_t):
    """Share of the previous frame's keypoints matched by either side whose
    matches land on the same pixel; None before both sides matched."""
    if rec_j is None or rec_t is None:
        return None
    k0j, k1j, mj = rec_j
    k0t, k1t, mt = rec_t
    to_t = _same_pixel(k0j, k0t)
    agree = total = 0
    for i in range(len(k0j)):
        it = to_t[i]
        a = mj[i]
        b = mt[it] if it >= 0 else -1
        if a < 0 and b < 0:
            continue
        total += 1
        agree += (a >= 0 and b >= 0
                  and np.linalg.norm(k1j[a] - k1t[b]) < PIX)
    return agree / total if total else None


def centre(pose):
    R, t = (np.asarray(x, np.float64) for x in pose)
    return -R.T @ t


def ate_cm(slam, R_gt, t_gt, times, trajectory):
    est_t, est_R, est_tcw = slam.get_trajectory()
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    fin = np.isfinite(est_pos).all(axis=1)
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times) if fin[i]]
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    return float(trajectory.ate_rmse(e, g, with_scale=True)[0] * 100.0), len(pairs)


IMU_CALIB = dict(sigma_g=1.7e-4 * np.sqrt(200.0), sigma_a=2e-3 * np.sqrt(200.0),
                 walk_g=1.9e-5 / np.sqrt(200.0), walk_a=3e-3 / np.sqrt(200.0))
BG_TRUE, BA_TRUE = (0.002, -0.001, 0.003), (-0.02, 0.03, 0.01)   # orbit_with_imu's


def inertial_ate_cm(slam, gt_pos, times, after_time, trajectory):
    """(metric ATE, scale-aligned ATE) in cm over the frames logged after
    after_time: frames logged before the IMU init hold poses relative to
    keyframes in the pre-alignment scale (stereo: every frame, -inf)."""
    est_t, est_R, est_tcw = slam.get_trajectory()
    est_pos = np.stack([-est_R[i].T @ est_tcw[i] for i in range(len(est_t))])
    pairs = [(i, j) for i, j in trajectory.associate_by_time(est_t, times)
             if est_t[i] > after_time and np.isfinite(est_pos[i]).all()]
    if len(pairs) < 3:
        return None, None
    e = np.stack([est_pos[i] for i, _ in pairs])
    g = np.stack([gt_pos[j] for _, j in pairs])
    return (float(trajectory.ate_rmse(e, g, with_scale=False)[0] * 100.0),
            float(trajectory.ate_rmse(e, g, with_scale=True)[0] * 100.0))


def record_solves(module, sink):
    """Wrap module.inertial_only_optimization to append each solve's
    (scale, gravity direction Rwg @ [0, 0, -1], bg, ba) to sink."""
    orig = module.inertial_only_optimization

    def recording(*a, **k):
        res = orig(*a, **k)
        sink.append({"scale": float(res.scale),
                     "g_dir": [float(x) for x in np.asarray(res.Rwg)[:, 2] * -1.0],
                     "bg": [float(x) for x in np.asarray(res.bg)],
                     "ba": [float(x) for x in np.asarray(res.ba)]})
        return res

    module.inertial_only_optimization = recording


def loop_report(slam) -> dict:
    """A system's fired loops and its loop closer's diagnostics."""
    lc = slam.loop_closer
    events = [{"kf": int(kf), "candidate": int(info["candidate"]),
               "n_inliers": int(info["n_inliers"]), "scale": float(info["scale"]),
               "n_fused": int(info["n_fused"]), "merge": bool(info.get("merge", False))}
              for kf, info in slam.loop_events]
    return {"events": events,
            "n_queries": len(lc.score_log),
            "n_dispatched": sum(1 for r in lc.score_log if r[3]),
            "best_seed_inliers": max((int(max(r[4])) for r in lc.cand_log if len(r[4])),
                                     default=0),
            "best_proj_inliers": max((int(r[6]) for r in lc.cand_log), default=0),
            "cand_log": [[int(r[0]), [int(x) for x in r[1]], [int(x) for x in r[4]], int(r[6])]
                         for r in lc.cand_log],
            "n_hyp_checks": len(lc.hyp_log)}


def run_apps(args):
    """--app: chip_smoke.py's path H tree (path G's scene as an EuRoC tree,
    its settings file and the shipped weights as official-layout .pth
    files) through rover_slam_tpu.apps.run_euroc and then
    rover_slam_tpu_torch.apps.run_euroc --device cpu, monocular-inertial,
    each package with its own RANSAC draws, as a user runs them; with
    --sensor stereo-inertial path J1's tree (the same scene as a rectified
    stereo tree, its settings with Stereo.T_c1_c2) and sensor. Prints each
    app's --stats-out, per-frame tracking states, the frame at which the
    IMU initialized, frames tracked, the final biases, the frames where the
    states differ and the largest distance between the two TUM
    trajectories' positions."""
    import tempfile
    import chip_smoke
    from rover_slam_tpu.apps import run_euroc as japp
    from rover_slam_tpu_torch.apps import run_euroc as tapp
    from rover_slam_tpu_torch.utils import trajectory

    root = args.tree or tempfile.mkdtemp(prefix="path_h_")
    stereo = "stereo" in args.sensor
    write = chip_smoke.write_path_j_tree if stereo else chip_smoke.write_path_h_tree
    tree = write(root, args.frames)
    method = "track_stereo_frame" if stereo else "track_frame"
    res = {}
    for name, app, extra in (("jax", japp, []), ("torch", tapp, ["--device", "cpu"])):
        rec, built = [], []
        orig = app.build_system

        def recording(*a, orig=orig, rec=rec, **k):
            slam = orig(*a, **k)
            built.append(slam)
            track = getattr(slam, method)

            def track_frame(*aa, **kk):
                info = track(*aa, **kk)
                rec.append((int(info["state"]), bool(getattr(slam, "imu_ready", False))))
                return info

            setattr(slam, method, track_frame)
            return slam

        app.build_system = recording
        paths = {k: os.path.join(root, f"{name}_{k}") for k in ("traj", "stats")}
        t0 = time.perf_counter()
        try:
            rc = app.main([tree["settings"], tree["mav0"], "--sensor", args.sensor,
                           "--out", paths["traj"], "--gt", tree["gt"],
                           "--stats-out", paths["stats"], "--superpoint-ckpt", tree["sp"],
                           "--lightglue-ckpt", tree["lg"], *extra])
        finally:
            app.build_system = orig
        with open(paths["stats"]) as f:
            stats = json.load(f)
        ready = [i for i, (_, r) in enumerate(rec) if r]
        res[name] = {"rc": rc, "seconds": time.perf_counter() - t0, "stats": stats,
                     "imu_ready_frame": ready[0] if ready else None,
                     "frames_tracked": sum(st == 2 for st, _ in rec),
                     "bg": np.asarray(built[0].bg).tolist(),
                     "ba": np.asarray(built[0].ba).tolist(),
                     "states": [st for st, _ in rec]}
        print(f"# {name}:", json.dumps({k: v for k, v in res[name].items() if k != "states"}),
              flush=True)
    sj, st = res["jax"]["states"], res["torch"]["states"]
    _, pj, _ = trajectory.load_tum(os.path.join(root, "jax_traj"))
    _, pt, _ = trajectory.load_tum(os.path.join(root, "torch_traj"))
    n = min(len(pj), len(pt))
    summary = {"frames": args.frames, "sensor": args.sensor, "states_equal": sum(a == b for a, b in zip(sj, st)),
               "states_differ_at": [i for i, (a, b) in enumerate(zip(sj, st)) if a != b],
               "traj_max_dist_m": float(np.linalg.norm(pj[:n] - pt[:n], axis=1).max()),
               "jax": {k: v for k, v in res["jax"].items() if k != "states"},
               "torch": {k: v for k, v in res["torch"].items() if k != "states"}}
    print("# summary:", json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "states": {"jax": sj, "torch": st}}, f)


STEREO_BASELINE = 0.11     # m, EuRoC's


def run_stereo(args):
    """--stereo: chip_smoke.py's path I scene (path C's ring photo world and
    orbit, rendered as rectified stereo pairs at STEREO_BASELINE with
    render_photo_stereo) through both packages' StereoSLAMs, synchronous,
    each with its own SuperPoint on both eyes and LightGlue as the frame
    matcher, loop closing on with LoopConfig(fix_scale=True,
    min_covis_weight=30). One line per frame (states, inliers, keyframes,
    stereo matches of each side, the distance between the two camera
    centres); at the end each side's metric ATE (Horn without scale: stereo
    is metric from frame 0) beside the scale-aligned one, frames tracked
    and the fired loops."""
    import jax.numpy as jnp
    import torch
    from rover_slam_tpu.geometry import cameras as jcam
    from rover_slam_tpu.models.lightglue import (LightGlueFrameMatcher as JLGF,
                                                 LightGlueMatcher as JLG)
    from rover_slam_tpu.models.superpoint import SuperPointExtractor as JSP
    from rover_slam_tpu.slam import stereo as jst, tracking as jT
    from rover_slam_tpu.slam.loop_closing import LoopConfig as JLoopConfig
    from rover_slam_tpu.training import checkpoints as ckpt
    from rover_slam_tpu.utils import trajectory
    from rover_slam_tpu_torch.geometry import cameras as tcam
    from rover_slam_tpu_torch.models.lightglue import (LightGlueFrameMatcher as TLGF,
                                                       LightGlueMatcher as TLG)
    from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor as TSP
    from rover_slam_tpu_torch.models.weights import load_flat_npz
    from rover_slam_tpu_torch.slam import stereo as tst, tracking as tT
    from rover_slam_tpu_torch.slam.loop_closing import LoopConfig as TLoopConfig
    from rover_slam_tpu_torch.utils import synthetic

    F = args.frames
    fx = 458.0
    cam = np.asarray([fx, fx, W / 2.0, H / 2.0, 0, 0, 0, 0], np.float32)
    world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=(H, W),
                                       layout="ring", ring_orbit_radius=5.0)
    world = world._replace(cam_params=cam)
    R_gt, t_gt, times = synthetic.orbit_trajectory(
        n_frames=F, orbit_radius=5.0, revs=1.1 * F / 160.0, dt=1.0 / 30.0)
    gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(F)])
    t0 = time.perf_counter()
    pairs = [np.stack(synthetic.render_photo_stereo(world, R_gt[i], t_gt[i],
                                                    STEREO_BASELINE)).astype(np.float32) / 255.0
             for i in range(F)]
    print(f"# rendered {F} stereo pairs in {time.perf_counter() - t0:.1f} s", flush=True)
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "rover_slam_tpu", "assets")
    sp_path = os.path.join(assets, "superpoint_synth.npz")
    lg_path = os.path.join(assets, "lightglue_synth.npz")
    cfg_kw = dict(image_hw=(H, W), local_map_only=True, kf_cull_every=0,
                  min_init_matches=40, min_inliers_local_map=20)
    lc_kw = dict(fix_scale=True, min_covis_weight=30)
    j_ext = JSP(params=ckpt.load_params(sp_path), image_hw=(H, W), max_keypoints=NK)
    j_slam = jst.StereoSLAM(cam, STEREO_BASELINE, config=jT.TrackerConfig(**cfg_kw),
                            map_capacity=CAPACITY, desc_dim=D, enable_loop_closing=True,
                            loop_config=JLoopConfig(**lc_kw),
                            matcher=JLGF(JLG(params=ckpt.load_params(lg_path), num_kpts=NK,
                                             num_layers=9, threshold=0.1), (H, W)))
    t_ext = TSP(params=load_flat_npz(sp_path), max_keypoints=NK, device="cpu")
    t_slam = tst.StereoSLAM(cam, STEREO_BASELINE, config=tT.TrackerConfig(**cfg_kw),
                            map_capacity=CAPACITY, desc_dim=D, enable_loop_closing=True,
                            loop_config=TLoopConfig(**lc_kw), device="cpu",
                            matcher=TLGF(TLG(params=load_flat_npz(lg_path), num_layers=9,
                                             threshold=0.1, device="cpu"), (H, W)))
    j_cam, t_cam = jnp.asarray(cam), torch.from_numpy(cam)
    rows, secs = [], {"jax": 0.0, "torch": 0.0}
    for i in range(F):
        t1 = time.perf_counter()
        o = j_ext(jnp.asarray(pairs[i]))
        k = o["keypoints"]
        info_j = j_slam.track_stereo_frame(
            k[0], jcam.unproject_jit(jcam.PINHOLE, j_cam, k[0]), o["descriptors"][0],
            o["valid"][0], k[1], o["descriptors"][1], o["valid"][1], float(times[i]))
        n_st_j = int(np.sum(np.asarray(j_slam._stereo_depth) > 0))
        t2 = time.perf_counter()
        with torch.no_grad():
            o = t_ext(torch.from_numpy(pairs[i]))
            k = o["keypoints"]
            info_t = t_slam.track_stereo_frame(
                k[0], tcam.unproject(tcam.PINHOLE, t_cam, k[0]), o["descriptors"][0],
                o["valid"][0], k[1], o["descriptors"][1], o["valid"][1], float(times[i]))
        n_st_t = int((t_slam._stereo_depth > 0).sum())
        t3 = time.perf_counter()
        secs["jax"] += t2 - t1
        secs["torch"] += t3 - t2
        dist = None
        if "pose" in info_j and "pose" in info_t:
            dist = float(np.linalg.norm(centre(info_j["pose"]) - centre(info_t["pose"])))
        row = {"frame": i, "state": [int(info_j["state"]), int(info_t["state"])],
               "n_inliers": [info_j.get("n_inliers"), info_t.get("n_inliers")],
               "n_kf": [int(j_slam.n_kf), int(t_slam.n_kf)],
               "stereo_matches": [n_st_j, n_st_t], "centre_dist": dist,
               "s": [round(t2 - t1, 2), round(t3 - t2, 2)]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    j_slam.flush()
    t_slam.flush()
    summary = {"frames": F, "seconds": secs,
               "frames_ok": {"jax": sum(r["state"][0] == jT.OK for r in rows),
                             "torch": sum(r["state"][1] == tT.OK for r in rows)},
               "states_equal": sum(r["state"][0] == r["state"][1] for r in rows),
               "n_kf": [int(j_slam.n_kf), int(t_slam.n_kf)],
               "n_lm": [int(j_slam.state.n_lm), int(t_slam.state.n_lm)],
               "stereo_matches_median": [float(np.median([r["stereo_matches"][s]
                                                          for r in rows])) for s in (0, 1)]}
    for name, slam in (("jax", j_slam), ("torch", t_slam)):
        metric, scaled = inertial_ate_cm(slam, gt_pos, times, -np.inf, trajectory)
        summary[name] = {"ate_metric_cm": metric, "ate_scaled_cm": scaled,
                         "loops": loop_report(slam)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)


def run_fisheye_si(args):
    """--fisheye-stereo-inertial: chip_smoke.py's path J2 second scene
    (tests/test_fisheye_inertial.py's 50-frame orbit_with_imu scene with a
    right eye through tests/test_fisheye_stereo.py's rig) through both
    packages' FisheyeStereoInertialSLAMs (tinit_s 1.0, tables 96 / 512 /
    16384), each fed the same frames and IMU samples. Prints each side's
    per-frame states, the frame at which the IMU initialized, its final
    biases and its metric ATE (Horn without scale) over the frames after
    the init, which sets chip_smoke.py's J2_SI_ATE_BOUND_CM."""
    import jax.numpy as jnp
    import chip_smoke
    from rover_slam_tpu.imu import preintegration as jpre
    from rover_slam_tpu.slam import stereo_inertial as jsi, tracking as jT
    from rover_slam_tpu_torch.geometry import cameras as tcam
    from rover_slam_tpu_torch.imu import preintegration as tpre
    from rover_slam_tpu_torch.slam import stereo_inertial as tsi, tracking as tT
    from rover_slam_tpu_torch.utils import trajectory
    left, right, (R_gt, t_gt, times), imu = chip_smoke.fisheye_si_scene()
    kb8, R_rl, t_rl = chip_smoke.fisheye_rig()
    noise = chip_smoke.FISHEYE_IMU
    calibs = {"jax": jpre.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3),
                                   **{k: jnp.float32(v) for k, v in noise.items()}),
              "torch": tpre.ImuCalib(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                     *(np.float32(noise[k]) for k in
                                       ("sigma_g", "sigma_a", "walk_g", "walk_a")))}
    gt = np.stack([-R.T @ t for R, t in zip(R_gt, t_gt)])
    res = {}
    for name, mod, T, kw in (("jax", jsi, jT, {}), ("torch", tsi, tT, dict(device="cpu"))):
        t0 = time.perf_counter()
        slam = mod.FisheyeStereoInertialSLAM(
            kb8, calibs[name], (R_rl, t_rl),
            config=T.TrackerConfig(cam_kind=tcam.KANNALA_BRANDT8, image_hw=(512, 512)),
            map_capacity=(96, 512, 16384), desc_dim=64, **kw)
        states, ready = [], None
        for i, (fl, fr) in enumerate(zip(left, right)):
            if i > 0:
                for a, g, t in zip(*imu[i - 1]):
                    slam.feed_imu(a, g, t)
            states.append(int(slam.track_stereo_frame(fl.kpts, fl.rays, fl.desc, fl.valid,
                                                      fr.rays, fr.desc, fr.valid,
                                                      fl.time)["state"]))
            if slam.imu_ready and ready is None:
                ready = i
        e_t, e_R, e_tcw = slam.get_trajectory()
        pos = np.stack([-e_R[i].T @ e_tcw[i] for i in range(len(e_t))])
        pairs = [(i, j) for i, j in trajectory.associate_by_time(e_t, times)
                 if ready is not None and j > ready]
        ate = 100.0 * trajectory.ate_rmse(np.stack([pos[i] for i, _ in pairs]),
                                          np.stack([gt[j] for _, j in pairs]),
                                          with_scale=False)[0]
        res[name] = {"seconds": time.perf_counter() - t0, "states": states,
                     "imu_ready_frame": ready, "n_kf": int(slam.n_kf),
                     "bg": np.asarray(slam.bg).tolist(), "ba": np.asarray(slam.ba).tolist(),
                     "ate_metric_after_init_cm": ate, "pos": pos}
        print(f"# {name}:", json.dumps({k: v for k, v in res[name].items() if k != "pos"}),
              flush=True)
    summary = {"states_equal": res["jax"]["states"] == res["torch"]["states"],
               "traj_max_dist_m": float(np.linalg.norm(res["jax"]["pos"] - res["torch"]["pos"],
                                                       axis=1).max()),
               **{f"{k}_ate_metric_after_init_cm": res[k]["ate_metric_after_init_cm"]
                  for k in res}}
    print("# summary:", json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, **{k: {kk: vv for kk, vv in v.items() if kk != "pos"}
                                              for k, v in res.items()}}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--pipeline", type=int, default=0, metavar="K")
    ap.add_argument("--loop", action="store_true",
                    help="loop closing on, LoopConfig(min_covis_weight=30) (bench.py's)")
    ap.add_argument("--inertial", action="store_true",
                    help="MonocularInertialSLAM on chip_smoke.py's path G scene")
    ap.add_argument("--app", action="store_true",
                    help="both packages' run_euroc apps on chip_smoke.py's path H tree")
    ap.add_argument("--stereo", action="store_true",
                    help="both packages' StereoSLAMs on chip_smoke.py's path I scene")
    ap.add_argument("--sensor", default="monocular-inertial",
                    help="--app: monocular-inertial (path H) or stereo-inertial (path J1)")
    ap.add_argument("--fisheye-stereo-inertial", action="store_true",
                    help="both packages' FisheyeStereoInertialSLAMs on path J2's scene")
    ap.add_argument("--tree", default=None, help="--app: directory for the EuRoC tree")
    ap.add_argument("--out", default=None, help="also write rows and summary here (JSON)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.app:
        return run_apps(args)
    if args.stereo:
        return run_stereo(args)
    if args.fisheye_stereo_inertial:
        return run_fisheye_si(args)

    import jax
    import jax.numpy as jnp
    import torch
    from rover_slam_tpu.geometry import cameras as jcam
    from rover_slam_tpu.models.lightglue import (LightGlueFrameMatcher as JLGF,
                                                 LightGlueMatcher as JLG)
    from rover_slam_tpu.models.superpoint import SuperPointExtractor as JSP
    from rover_slam_tpu.slam import tracking as jT
    from rover_slam_tpu.slam.loop_closing import LoopConfig as JLoopConfig
    from rover_slam_tpu.slam.system import MonocularSLAM as JSLAM
    from rover_slam_tpu.training import checkpoints as ckpt
    from rover_slam_tpu.utils import trajectory
    from rover_slam_tpu_torch.geometry import cameras as tcam
    from rover_slam_tpu_torch.models.lightglue import (LightGlueFrameMatcher as TLGF,
                                                       LightGlueMatcher as TLG)
    from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor as TSP
    from rover_slam_tpu_torch.models.weights import load_flat_npz
    from rover_slam_tpu_torch.slam import tracking as tT
    from rover_slam_tpu_torch.slam.loop_closing import LoopConfig as TLoopConfig
    from rover_slam_tpu_torch.slam.system import MonocularSLAM as TSLAM
    from rover_slam_tpu_torch.utils import synthetic

    assert jax.default_backend() == "cpu"
    F = args.frames
    fx = 458.0
    cam = np.asarray([fx, fx, W / 2.0, H / 2.0, 0, 0, 0, 0], np.float32)
    world = synthetic.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=(H, W),
                                       layout="ring", ring_orbit_radius=5.0)
    world = world._replace(cam_params=cam)
    if args.inertial:
        R_gt, t_gt, times, _, imu = synthetic.orbit_with_imu(
            n_frames=F, orbit_radius=5.0, revs=1.1 * F / 160.0, dt=1.0 / 30.0, hz=200)
        args.loop = True
    else:
        R_gt, t_gt, times = synthetic.orbit_trajectory(
            n_frames=F, orbit_radius=5.0, revs=1.1 * F / 160.0, dt=1.0 / 30.0)
    t0 = time.perf_counter()
    imgs = [synthetic.render_photo_frame(world, R_gt[i], t_gt[i]).astype(np.float32) / 255.0
            for i in range(F)]
    print(f"# rendered {F} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "rover_slam_tpu", "assets")
    sp_path = os.path.join(assets, "superpoint_synth.npz")
    lg_path = os.path.join(assets, "lightglue_synth.npz")
    cfg_kw = dict(image_hw=(H, W), local_map_only=True, kf_cull_every=0,
                  min_init_matches=40, min_inliers_local_map=20)

    j_ext = JSP(params=ckpt.load_params(sp_path), image_hw=(H, W), max_keypoints=NK)
    j_rec = Recorder(JLGF(JLG(params=ckpt.load_params(lg_path), num_kpts=NK, num_layers=9,
                              threshold=0.1), (H, W)))
    lc_kw = dict(min_covis_weight=30, fix_scale=True) if args.inertial \
        else dict(min_covis_weight=30)
    solves = {"jax": [], "torch": []}
    j_kw = t_kw = {}
    if args.inertial:
        from rover_slam_tpu.imu import preintegration as jpre
        from rover_slam_tpu.optim import inertial_init as jii
        from rover_slam_tpu.slam.inertial_system import MonocularInertialSLAM as JSLAM
        from rover_slam_tpu_torch.optim import inertial_init as tii
        from rover_slam_tpu_torch.slam.inertial_system import MonocularInertialSLAM as TSLAM
        calib = jpre.ImuCalib(Rbc=jnp.eye(3), tbc=jnp.zeros(3),
                              **{k: jnp.float32(v) for k, v in IMU_CALIB.items()})
        j_kw = t_kw = dict(imu_calib=calib, tinit_s=2.0)
        record_solves(jii, solves["jax"])
        record_solves(tii, solves["torch"])
    j_slam = JSLAM(cam, config=jT.TrackerConfig(**cfg_kw), map_capacity=CAPACITY,
                   desc_dim=D, pipeline=args.pipeline, enable_loop_closing=args.loop,
                   loop_config=JLoopConfig(**lc_kw) if args.loop else None,
                   matcher=j_rec, **j_kw)
    j_cam = jnp.asarray(cam)

    t_ext = TSP(params=load_flat_npz(sp_path), max_keypoints=NK, device="cpu")
    t_rec = Recorder(TLGF(TLG(params=load_flat_npz(lg_path), num_layers=9, threshold=0.1,
                              device="cpu"), (H, W)))
    t_slam = TSLAM(cam, config=tT.TrackerConfig(**cfg_kw), map_capacity=CAPACITY,
                   desc_dim=D, pipeline=args.pipeline, enable_loop_closing=args.loop,
                   loop_config=TLoopConfig(**lc_kw) if args.loop else None,
                   matcher=t_rec, device="cpu", **t_kw)
    t_cam = torch.from_numpy(cam)

    rows = []
    secs = {"jax": 0.0, "torch": 0.0}
    ready = {"jax": None, "torch": None}
    for i in range(F):
        j_rec.last = t_rec.last = None
        if args.inertial and i > 0:
            for slam in (j_slam, t_slam):
                for a, g, t in zip(*imu[i - 1]):
                    slam.feed_imu(a, g, t)
        t1 = time.perf_counter()
        out = j_ext(jnp.asarray(imgs[i][None]))
        kj = out["keypoints"][0]
        info_j = j_slam.track_frame(kj, jcam.unproject_jit(jcam.PINHOLE, j_cam, kj),
                                    out["descriptors"][0], out["valid"][0], float(times[i]))
        kj = np.asarray(kj)
        t2 = time.perf_counter()
        with torch.no_grad():
            out = t_ext(torch.from_numpy(imgs[i][None]))
            kt = out["keypoints"][0]
            info_t = t_slam.track_frame(kt, tcam.unproject(tcam.PINHOLE, t_cam, kt),
                                        out["descriptors"][0], out["valid"][0],
                                        float(times[i]))
        kt = kt.numpy()
        t3 = time.perf_counter()
        secs["jax"] += t2 - t1
        secs["torch"] += t3 - t2
        dist = None
        if "pose" in info_j and "pose" in info_t:
            dist = float(np.linalg.norm(centre(info_j["pose"]) - centre(info_t["pose"])))
        row = {"frame": i,
               "same_kpts": int((_same_pixel(kj, kt) >= 0).sum()),
               "matches": [None if r.last is None else int((r.last[2] >= 0).sum())
                           for r in (j_rec, t_rec)],
               "match_agree": match_agreement(j_rec.last, t_rec.last),
               "state": [int(info_j["state"]), int(info_t["state"])],
               "n_inliers": [info_j.get("n_inliers"), info_t.get("n_inliers")],
               "n_kf": [int(j_slam.n_kf), int(t_slam.n_kf)],
               "centre_dist": dist,
               "s": [round(t2 - t1, 2), round(t3 - t2, 2)]}
        if args.inertial:
            for name, slam in (("jax", j_slam), ("torch", t_slam)):
                if slam.imu_ready and ready[name] is None:
                    ready[name] = i
            row["imu_ready"] = [bool(j_slam.imu_ready), bool(t_slam.imu_ready)]
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.pipeline and i == 39:
            j_slam.flush()
            t_slam.flush()

    if args.pipeline or args.loop:
        j_slam.flush()
        t_slam.flush()
    ate = {"jax": ate_cm(j_slam, R_gt, t_gt, times, trajectory),
           "torch": ate_cm(t_slam, R_gt, t_gt, times, trajectory)}
    agree = [r["match_agree"] for r in rows if r["match_agree"] is not None]
    dists = [r["centre_dist"] for r in rows if r["centre_dist"] is not None]
    summary = {
        "frames": F,
        "ate_cm": {k: v[0] for k, v in ate.items()},
        "frames_scored": {k: v[1] for k, v in ate.items()},
        "frames_ok": {"jax": sum(r["state"][0] == jT.OK for r in rows),
                      "torch": sum(r["state"][1] == tT.OK for r in rows)},
        "states_equal": sum(r["state"][0] == r["state"][1] for r in rows),
        "n_kf": [int(j_slam.n_kf), int(t_slam.n_kf)],
        "n_lm": [int(j_slam.state.n_lm), int(t_slam.state.n_lm)],
        "match_agree_median": float(np.median(agree)) if agree else None,
        "match_agree_min": float(np.min(agree)) if agree else None,
        "centre_dist_median": float(np.median(dists)) if dists else None,
        "centre_dist_max": float(np.max(dists)) if dists else None,
        "first_frame_centre_dist_over_0.01": next(
            (r["frame"] for r in rows
             if r["centre_dist"] is not None and r["centre_dist"] > 0.01), None),
        "seconds": secs}
    if args.loop:
        summary["loops"] = {name: loop_report(slam)
                            for name, slam in (("jax", j_slam), ("torch", t_slam))}
    if args.inertial:
        gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(F)])
        summary["inertial"] = {}
        for name, slam in (("jax", j_slam), ("torch", t_slam)):
            after = float(times[ready[name]]) if ready[name] is not None else np.inf
            metric, scaled = inertial_ate_cm(slam, gt_pos, times, after, trajectory)
            summary["inertial"][name] = {
                "imu_ready_frame": ready[name], "solves": solves[name],
                "ate_metric_cm": metric, "ate_scaled_cm": scaled,
                "bg": [float(x) for x in np.asarray(slam.bg)],
                "ba": [float(x) for x in np.asarray(slam.ba)],
                "bg_true": list(BG_TRUE), "ba_true": list(BA_TRUE),
                "pose_graph_mode": slam.loop_closer.pose_graph_mode}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
