"""bench_port.py, the port's twin of bench.py, on the CPU.

- The scene: bench_port.bench_scene() against the world, orbit and a
  rendered frame bench.py builds with rover_slam_tpu.utils.synthetic. The
  world's arrays come from the same numpy draws and are equal to the bit;
  the orbit's rotations go through each package's so3_exp (XLA's and
  torch's sin / cos), within 1e-6; a rendered frame within one grey level.
- main() at a cut size (240x320, 192 keypoints, 2 LightGlue layers, 30
  frames, 16 of them warm-up): one JSON line on stdout with every key that
  bench.py's line has (read from bench.py's source), the port's additions,
  and the device it ran on.
- frac_frames_tracked, ate_cm, loop_events and loop_diag against
  bench.py's own expressions (copied below from bench.py) on a hand-made
  trajectory and loop-closer log.
"""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import bench_port
import torch_parity  # noqa: F401  (its import sets one torch thread a test worker)
from rover_slam_tpu.geometry import cameras as jcam
from rover_slam_tpu.utils import synthetic as jsyn
from rover_slam_tpu.utils import trajectory as jtraj
from rover_slam_tpu_torch.utils import synthetic as tsyn

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W = bench_port.H, bench_port.W
CUT = dict(n_frames=30, n_warm=16, hw=(240, 320), n_kpts=192, layers=2,
           tables=(32, 4096), reps=2)


def test_scene_equals_bench_py():
    cam, world, (R, t, times) = bench_port.bench_scene()
    jworld = jsyn.make_photo_world(n_sprites=1400, patch=17, seed=0, image_hw=(H, W),
                                   layout="ring", ring_orbit_radius=5.0)
    jworld = jworld._replace(cam_params=np.asarray(jcam.make_pinhole(458.0, 458.0, W / 2.0,
                                                                     H / 2.0)))
    Rj, tj, timesj = jsyn.orbit_trajectory(n_frames=160, orbit_radius=5.0, revs=1.1,
                                           dt=1.0 / 30.0)
    np.testing.assert_array_equal(cam, np.asarray(jworld.cam_params))
    for f in ("points", "patches", "z0"):
        np.testing.assert_array_equal(getattr(world, f), getattr(jworld, f))
    assert (world.cam_kind, tuple(world.image_hw)) == (jworld.cam_kind, tuple(jworld.image_hw))
    assert len(times) == 160
    np.testing.assert_array_equal(times, timesj)
    np.testing.assert_allclose(R, Rj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t, tj, rtol=0, atol=1e-6)
    for i in (0, 97):
        img = tsyn.render_photo_frame(world, R[i], t[i]).astype(np.int32)
        ref = np.asarray(jsyn.render_photo_frame(jworld, Rj[i], tj[i])).astype(np.int32)
        assert img.shape == ref.shape == (H, W)
        assert np.abs(img - ref).max() <= 1


def _bench_py_keys():
    """The keys of bench.py's JSON line, nested, from its source: the dict
    handed to json.dumps in main() and the loop_diag dict it names."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    named = {n.targets[0].id: n.value for n in ast.walk(main)
             if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
             and isinstance(n.value, ast.Dict)}
    line = next(n.args[0] for n in ast.walk(main) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps")

    def keys(d):
        out = {}
        for k, v in zip(d.keys, d.values):
            if isinstance(v, ast.Name) and v.id in named:
                v = named[v.id]
            out[k.value] = keys(v) if isinstance(v, ast.Dict) else None
        return out
    return keys(line)


def _assert_has_keys(got, want, where="line"):
    for k, sub in want.items():
        assert k in got, f"{where}: {k} missing"
        if sub is not None:
            _assert_has_keys(got[k], sub, f"{where}.{k}")


def test_main_prints_bench_py_line(capsys):
    want = _bench_py_keys()
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(want)
    assert {"frame_ms", "loop_diag", "ate_cm", "superpoint_ms"} <= set(want["detail"])
    assert bench_port.main(device="cpu", **CUT) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    _assert_has_keys(line, want)
    d = line["detail"]
    assert line["metric"] == "mono_tracking_fps_per_chip" and line["unit"] == "frames/s"
    assert line["vs_baseline"] == pytest.approx(line["value"] / 30.0)
    assert d["frames_timed"] == CUT["n_frames"] - CUT["n_warm"]
    assert d["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}
    assert len(d["trajectory_digest"]) == 16 and d["stage_median_ms"]
    # The cut run tracks (bench.py's gates on the card are >= 90 % and a loop).
    assert d["n_kf"] > 2 and d["frac_frames_tracked"] >= 0.9 and d["frames_tracked_ok"] >= 0.9
    assert np.isfinite(d["ate_cm"])
    assert d["superpoint_ms"] > 0 and d["lightglue_ms"] > 0


def test_main_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    assert bench_port.main() == 1


class _Slam:
    """What bench.py reads of a system: the trajectory, the loop events and
    the loop closer's logs."""

    def __init__(self, traj, loop_events, score_log, cand_log, hyp_log):
        self._traj = traj
        self.loop_events = loop_events
        self.loop_closer = type("LC", (), dict(score_log=score_log, cand_log=cand_log,
                                               hyp_log=hyp_log))()

    def get_trajectory(self):
        return self._traj


def _hand_made(rng, n=40, n_bad=5):
    _, _, (R_gt, t_gt, times) = bench_port.bench_scene(n_frames=n, hw=(60, 80))
    est_t = times[3:] + 0.001                              # frames 0-2 never logged
    est_R = np.stack([R_gt[i] for i in range(3, n)]).astype(np.float32)
    est_tcw = np.stack([0.8 * t_gt[i] + rng.normal(0, 0.01, 3) for i in range(3, n)])
    bad = rng.choice(len(est_t), n_bad, replace=False)
    est_tcw[bad[:2]] = np.nan
    est_R[bad[2:]] = np.nan
    score_log = [(k, float(rng.uniform()), float(rng.uniform(0, 0.5)), bool(k % 3 == 0))
                 for k in range(12)]
    cand_log = [(k, [1, 2], [30, 12], [True, False], [int(rng.integers(0, 90)), 4], 0,
                 int(rng.integers(0, 200))) for k in range(5)] + [(7, [], [], [], [], -1, 0)]
    hyp_log = [(3, 4, 1, 50, 1, 0), (4, 5, 1, 60, 2, 0)]
    events = [(11, {"loop": True, "candidate": 1, "query_kf": 11, "n_inliers": 185,
                    "scale": 0.99, "n_fused": 40, "pg_cost": 1.5})]
    return (R_gt, t_gt, times), _Slam((est_t, est_R, est_tcw.astype(np.float32)), events,
                                      score_log, cand_log, hyp_log)


def _bench_py_quality(slam, R_gt, t_gt, times):
    """bench.py main()'s ate_cm and frac_frames_tracked, as written there."""
    est_t, est_R, est_tcw = slam.get_trajectory()
    ate_cm = float("nan")
    pairs = []
    frac_tracked = 0.0
    if len(est_t) > 10:
        est_pos = np.stack([-est_R[i].T @ est_tcw[i]
                            for i in range(len(est_t))])
        fin = (np.isfinite(est_pos).all(axis=1)
               & np.isfinite(est_R.reshape(len(est_t), -1)).all(axis=1))
        frac_tracked = float(fin.mean())
        gt_pos = np.stack([-R_gt[i].T @ t_gt[i] for i in range(len(times))])
        pairs = [(i, j) for i, j in
                 jtraj.associate_by_time(est_t, times) if fin[i]]
    if len(pairs) > 10:
        e = np.stack([est_pos[i] for i, _ in pairs])
        g = np.stack([gt_pos[j] for _, j in pairs])
        rmse, _ = jtraj.ate_rmse(e, g, with_scale=True)
        ate_cm = round(float(rmse * 100), 2)
    return ate_cm, round(frac_tracked, 3)


def _bench_py_loop(slam):
    """bench.py main()'s loop_diag and loop_events, as written there."""
    lc = slam.loop_closer
    loop_diag = {
        "n_queries": len(lc.score_log),
        "n_dispatched": sum(1 for r in lc.score_log if r[3]),
        "max_retrieval_score": round(max((r[1] for r in lc.score_log),
                                         default=0.0), 4),
        "max_minscore_gate": round(max((r[2] for r in lc.score_log),
                                       default=0.0), 4),
        "best_seed_inliers": max((max(r[4]) for r in lc.cand_log
                                  if len(r) > 4 and r[4]), default=0),
        "best_proj_inliers": max((r[6] for r in lc.cand_log
                                  if len(r) > 6), default=0),
        "n_hyp_checks": len(lc.hyp_log),
    }
    events = [
        {"kf": int(k), "candidate": int(li.get("candidate", -1)),
         "n_inliers": int(li.get("n_inliers", 0)),
         "merge": bool(li.get("merge", False)),
         "n_fused": int(li.get("n_fused", 0))}
        for k, li in slam.loop_events]
    return loop_diag, events


@pytest.mark.parametrize("seed", [0, 1])
def test_quality_and_loop_fields_follow_bench_py(seed):
    """bench_port reports its numbers unrounded; bench.py rounds ate_cm to
    0.01, frac_frames_tracked to 0.001 and the two scores to 1e-4."""
    gt, slam = _hand_made(np.random.default_rng(seed))
    ate_ref, frac_ref = _bench_py_quality(slam, *gt)
    q = bench_port.trajectory_quality(slam, *gt)
    assert q["frac_frames_tracked"] == pytest.approx(frac_ref, abs=5e-4)
    assert q["frac_frames_tracked"] == pytest.approx(32 / 37)
    assert q["ate_cm"] == pytest.approx(ate_ref, abs=5e-3) and np.isfinite(ate_ref)
    diag_ref, events_ref = _bench_py_loop(slam)
    diag = bench_port.loop_summary(slam)["loop_diag"]
    assert diag.keys() == diag_ref.keys()
    for k, v in diag_ref.items():
        assert diag[k] == pytest.approx(v, abs=5e-5), k
    assert bench_port.bench_loop_events(slam) == events_ref


def test_quality_of_a_short_trajectory_follows_bench_py():
    """Ten poses or fewer: bench.py reports frac 0 and no ATE."""
    gt, slam = _hand_made(np.random.default_rng(2))
    est_t, est_R, est_tcw = slam.get_trajectory()
    slam._traj = (est_t[:10], est_R[:10], est_tcw[:10])
    ate_ref, frac_ref = _bench_py_quality(slam, *gt)
    q = bench_port.trajectory_quality(slam, *gt)
    assert q["frac_frames_tracked"] == frac_ref == 0.0
    assert np.isnan(q["ate_cm"]) and np.isnan(ate_ref)
