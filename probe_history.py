"""Does path G's result depend on what ran before it in the process? (C4 in
ROADMAP.md.)

    python3 probe_history.py [--out DIR]

Runs chip_smoke.py's path G (synchronous, 160 frames) in two fresh
processes on one GPU: one that runs path G alone, one that runs path B
first. Each logs, after every frame, the tracking state, the keyframe and
landmark counts, a digest of the keyframe poses and landmark positions, the
loop closer's readiness polls (queue length, index of the freshest landed
copy), the loops fired, the scale alignments, a digest of the inertial
body state (keyframe velocities and biases), each inertial-only solve (a
digest of its problem and its scale) and each scale refinement (its chain
length, segments, and whether it applied an alignment). Prints both trajectory digests
and the first frame at which the two logs differ. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


def run_one(mode: str, out: str):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import chip_smoke as cs
    from rover_slam_tpu_torch.slam import inertial_system as IS, loop_closing as L

    polls, solves, refines = [], [], []
    freshest = L.LoopCloser._freshest_ready
    solve = IS.ii.inertial_only_optimization
    refine = IS.MonocularInertialSLAM._refine_scale

    def logged(queue):
        r = freshest(queue)
        polls.append((len(queue), r))
        return r

    def logged_solve(prob, *a, **k):
        res = solve(prob, *a, **k)
        solves.append((_digest(*(x for x in prob if isinstance(x, torch.Tensor))),
                       float(res.scale)))
        return res

    def logged_refine(self, *a, **k):
        n = len(self.scale_log)
        idx, segs = self._init_chain()
        refine(self, *a, **k)
        refines.append((len(idx), len(segs), len(self.scale_log) > n))

    L.LoopCloser._freshest_ready = staticmethod(logged)
    IS.ii.inertial_only_optimization = logged_solve
    IS.MonocularInertialSLAM._refine_scale = logged_refine
    dev = torch.device("cuda", 0)
    cs.phase_build()
    if mode == "after_b":
        cs.phase_path_b(dev)
    scene = cs.PathG(dev)
    scene.warm_up()
    slam = scene.new_slam(pipeline=0)
    rows = []
    for i in range(len(scene.imgs)):
        polls.clear()
        solves.clear()
        refines.clear()
        info = scene.step(slam, i)
        st = slam.state
        rows.append({"frame": i, "state": int(info["state"]), "n_kf": slam.n_kf,
                     "n_lm": int(st.n_lm), "map": _digest(st.kf_R_cw, st.kf_t_cw, st.lm_pos),
                     "body": _digest(st.kf_v_wb, st.kf_bg, st.kf_ba), "polls": list(polls),
                     "loops": len(slam.loop_events), "scales": len(slam.scale_log),
                     "solves": list(solves), "refines": list(refines)})
    slam.flush()
    with open(out, "w") as f:
        json.dump({"rows": rows, "scale_log": slam.scale_log,
                   "digest": cs.trajectory_digest(slam)}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="probe_out")
    ap.add_argument("--mode", choices=["alone", "after_b"], help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_history.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    os.makedirs(args.out, exist_ok=True)
    paths = {m: os.path.join(args.out, f"probe_history_{m}.json") for m in ("alone", "after_b")}
    if args.mode:
        return run_one(args.mode, paths[args.mode])
    for m in paths:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--out", args.out,
                        "--mode", m], check=True, stdout=subprocess.DEVNULL)
    logs = {}
    for m, p in paths.items():
        with open(p) as f:
            logs[m] = json.load(f)
    print(json.dumps({m: {"digest": v["digest"], "scale_log": v["scale_log"]}
                      for m, v in logs.items()}))
    for a, b in zip(logs["alone"]["rows"], logs["after_b"]["rows"]):
        if a != b:
            print(json.dumps({"first_difference": a["frame"], "alone": a, "after_b": b}))
            break
    else:
        print(json.dumps({"first_difference": None}))


if __name__ == "__main__":
    main()
