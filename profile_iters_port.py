"""Sweep of pose-optimisation schedules in the port's fused track+map
program at the bench's widths: the twin of profile_iters.py.

    python3 profile_iters_port.py       # needs a CUDA device; exits 1 without one

The scene is profile_iters.py's: bench_port.py's ring photo world at
480x640, 50 frames of orbit_trajectory over 0.33 revolutions at 1/30 s,
SuperPoint (1024 keypoints, 256-D) and 9-layer LightGlue from the shipped
npz, LightGlue as the frame matcher, bench.py's TrackerConfig, tables 512 /
1024 / 16384, loop closing off, pipeline=4; every frame, then flush. On the
map that run leaves, slam/tracking.py _track_and_map_body
(profile_stages_port.fused_call: the last frame tracked again against
itself, mutual-NN matching on kernel B2) runs under each schedule
(motion_rounds, motion_iters, local_rounds, local_iters) of SCHEDULES, as
"track" (fs 0: no insert), "insert" (fs 99, the config's ba_iters) and
"insert_ba1" (fs 99, one BA iteration). It prints profile_iters.py's line
for each, "(mr,mi,lr,li) tag: <ms> ms ok= n_inl= ins=" (the program's flags
0, 1 and 5), then b1=, b2= and syncs=: one call's kernel B1 and B2 launches
and its implicit host syncs (torch.cuda.set_sync_debug_mode("warn")). The
policy carry is [fs, 200, 0]: profile_iters.py passes [fs, 200], whose
missing third entry XLA's clamped read takes from the second; with
ba_every 1 the BA runs either way, so only the returned carry differs. The
last line is the card's name and power limit (nvidia-smi).

A time here is the eager port's host-inclusive time a call, not an XLA
program's: profile_iters.py's protocol (2 warm-up calls, then 6 calls ended
by one device synchronize), every call on its own clone of the map, less the
clone's time (state_copy_ms, printed first).
"""
from __future__ import annotations

import sys

import torch

from bench_port import H, LIGHTGLUE_LAYERS, NK, W, card, clone_state, counts, log, profile_call
from profile_stages_port import copy_ms, fused_call, orbit_scene, run_scene

N_FRAMES, REVS = 50, 0.33
SCHEDULES = ((2, 5, 2, 6), (1, 4, 2, 4), (1, 3, 2, 3), (1, 3, 1, 4))


def tags(cfg):
    """(tag, fs, ba_iters) of each profile_iters.py line of a schedule."""
    return (("track", 0.0, cfg.ba_iters), ("insert", 99.0, cfg.ba_iters), ("insert_ba1", 99.0, 1))


def sweep(slam, dev, warmup: int = 2, reps: int = 6, emit=log) -> dict:
    """profile_iters.py's sweep on slam's map. Returns {(schedule, tag):
    bench_port.profile_call's result plus ok, n_inl and ins}."""
    st, prev, cfg = slam.state, slam.last_frame, slam.cfg
    cp = copy_ms(st, dev, warmup, reps)
    emit(f"state_copy_ms {cp['ms']} {counts(cp)}")
    res = {}
    for sched in SCHEDULES:
        for tag, fs, ba in tags(cfg):
            r = res[(sched, tag)] = profile_call(
                lambda sched=sched, fs=fs, ba=ba: fused_call(clone_state(st), prev, cfg,
                                                             slam.cam_params, fs, ba, sched),
                dev, warmup, reps, minus_ms=cp["ms"])
            fl = r["out"][-1].cpu().numpy()
            r.update(ok=int(fl[0]), n_inl=int(fl[1]), ins=int(fl[5]))
            emit("(%d,%d,%d,%d) %s: %s ms ok=%d n_inl=%d ins=%d %s"
                 % (*sched, tag, r["ms"], r["ok"], r["n_inl"], r["ins"], counts(r)))
    return res


def run(device=None, n_frames: int = N_FRAMES, revs: float = REVS, hw=(H, W), n_kpts: int = NK,
        layers: int = LIGHTGLUE_LAYERS, tables=None, warmup: int = 2, reps: int = 6,
        emit=log) -> dict:
    """profile_iters.py's protocol on the port; device None is the card, the
    other arguments cut the widths and the frames."""
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    scene = orbit_scene(dev, n_frames, revs, hw=hw, n_kpts=n_kpts, layers=layers, tables=tables)
    slam = run_scene(scene, loop=False)
    emit("n_kf:", slam.n_kf)
    return sweep(slam, dev, warmup, reps, emit=emit)


def main(device=None, **cut) -> int:
    """Print profile_iters.py's lines for the port. Without a CUDA device it
    fails unless the caller asks for another device (the CPU tests do, with
    a cut size)."""
    if device is None and not torch.cuda.is_available():
        print("profile_iters_port.py: no CUDA device", file=sys.stderr)
        return 1
    run(device, **cut)
    print(card() if device is None else f"device {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
