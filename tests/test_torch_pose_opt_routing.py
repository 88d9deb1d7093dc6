"""optim/pose_opt.py's routing on the CPU: CPU tensors run the plain twin,
to the bit and with no kernel launch counted; the kernel's source is built
with the others; and every caller in the port hands pose_optimization
arguments the kernel takes (checked here with the kernel's own argument
checks on a short CPU run of the tracker, relocalization and PnP). The
kernel itself is compared with the plain twin on the card in
tests/test_torch_cuda.py."""
import os
import traceback

import pytest
import torch

import pose_opt_problems
import torch_parity
from rover_slam_tpu_torch.geometry import cameras
from rover_slam_tpu_torch.ops import _build
from rover_slam_tpu_torch.optim import pnp
from rover_slam_tpu_torch.optim import pose_opt as po
from rover_slam_tpu_torch.slam import tracking
from rover_slam_tpu_torch.slam.system import MonocularSLAM
from rover_slam_tpu_torch.utils import profiling


@pytest.mark.parametrize("check_cost,rounds,iters", [(False, 2, 5), (False, 2, 6),
                                                     (True, 4, 10)])
@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("cam_kind", [cameras.PINHOLE, cameras.KANNALA_BRANDT8])
def test_cpu_tensors_run_the_plain_twin(cam_kind, stereo, check_cost, rounds, iters):
    kw = pose_opt_problems.problem(200, cam_kind, stereo, seed=5)
    sched = dict(rounds=rounds, iters_per_round=iters, check_cost=check_cost)
    saved = profiling.snapshot_counters()
    try:
        profiling.reset_counters()
        out = po.pose_optimization(**kw, **sched)
        assert profiling.counter("pose_opt_launches") == 0
    finally:
        profiling.reset_counters(saved)
    ref = po.pose_optimization_plain(**kw, **sched)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(out.n_inliers) > 150


def test_kernel_source_is_built_with_the_others():
    assert "pose_opt" in _build.SOURCES
    assert os.path.exists(os.path.join(_build.CSRC, "pose_opt.cu"))


def test_check_args_refuses_what_the_kernel_does_not_take():
    kw = pose_opt_problems.problem(50, cameras.PINHOLE, True, seed=6)

    def check(**change):
        a = {**kw, **change}
        return po.check_args(a["R_cw"], a["t_cw"], a["Xw"], a["uv"], a["valid"],
                             a["cam_params"], a["cam_kind"], a.get("info"), 2, 5,
                             a.get("invd"), a.get("bf"))

    assert check() == (50, True)
    assert check(invd=None) == (50, False)
    for change in (dict(Xw=kw["Xw"].double()), dict(uv=kw["uv"].T.contiguous().T),
                   dict(valid=kw["valid"].float()), dict(R_cw=kw["R_cw"].T),
                   dict(cam_params=kw["cam_params"][:4]), dict(info=torch.ones(49)),
                   dict(bf=float(pose_opt_problems.BF)), dict(cam_kind=2)):
        with pytest.raises((ValueError, TypeError)):
            check(**change)
    with pytest.raises(ValueError):
        po._launch(*(kw[k] for k in ("R_cw", "t_cw", "Xw", "uv", "valid", "cam_params",
                                     "cam_kind")), None, 2, 5, 5.991, False, None, None)


def test_callers_hand_the_kernel_what_it_takes(monkeypatch):
    """The tracker's motion, reference-keyframe and local-map stages (a
    short CPU run, then an unmatchable frame: the motion model fails),
    relocalization's guided passes and pnp_ransac's refinement on the map it
    built: each call's arguments pass the kernel's checks."""
    callers = []
    plain = po.pose_optimization_plain

    def checked(R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind=cameras.PINHOLE,
                info=None, rounds=4, iters_per_round=10, chi2_th=5.991, check_cost=True,
                invd=None, bf=None):
        po.check_args(R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind, info, rounds,
                      iters_per_round, invd, bf)
        callers.append(traceback.extract_stack(limit=4)[0].name)
        return plain(R_cw, t_cw, Xw, uv, valid, cam_params, cam_kind, info, rounds,
                     iters_per_round, chi2_th, check_cost, invd, bf)

    monkeypatch.setattr(po, "pose_optimization_plain", checked)
    world, frames, _ = torch_parity.synthetic_frames(8)
    slam = MonocularSLAM(world.cam_params, map_capacity=(32, 512, 8192), desc_dim=64,
                         device="cpu")
    torch_parity.feed(slam, frames)
    assert slam.tracking_state == tracking.OK and len(callers) >= 2
    junk = torch_parity.garbage_frames(1, frames[-1].time + 0.1, seed=0)[0]
    before = len(slam.timers.samples.get("track.ref_kf", []))
    slam.track_frame(junk.kpts, junk.rays, junk.desc, junk.valid, junk.time)
    assert len(slam.timers.samples["track.ref_kf"]) == before + 1
    st = slam.state
    f = frames[-1]
    kpts, desc = torch.from_numpy(f.kpts), torch.from_numpy(f.desc)
    valid = torch.from_numpy(f.valid)
    lm = torch.full((kpts.shape[0],), -1, dtype=torch.int32)
    R0, t0 = st.kf_R_cw[0].contiguous(), st.kf_t_cw[0].contiguous()
    tracking._reloc_guided(st, st.lm_active, kpts, desc, valid, slam.cam_params,
                           cameras.PINHOLE, R0, t0, lm)
    Xw = st.lm_pos[:kpts.shape[0]]
    pnp.pnp_ransac(Xw, kpts, st.lm_active[:kpts.shape[0]], slam.cam_params,
                   generator=torch.Generator().manual_seed(0), n_hyp=16)
    assert set(callers) == {"_track_step_body", "_reloc_expand", "pnp_ransac"}
