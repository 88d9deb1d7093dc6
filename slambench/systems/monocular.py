"""The port's MonocularSLAM as a configuration states it, driven one frame at
a time through the user's entry points: the frame's uint8 image copied to
the device and scaled to [0, 1], SuperPointExtractor.__call__ on it,
cameras.unproject, MonocularSLAM.track_frame (LightGlue runs inside as
its frame matcher, behind the benchmark's proxy), then a device synchronize.
bench_port.py's PathA and run_path_c are the model: the same front end,
tracker configuration, capacities, warm-up on a throw-away system, and
flush + precompile before the window."""
from __future__ import annotations

import numpy as np
import torch

from slambench.harness import MatcherProxy, sync


class System:
    def __init__(self, cfg: dict, scene, frames: np.ndarray, trees: dict, dev, cap):
        from rover_slam_tpu_torch.models.lightglue import LightGlueFrameMatcher, LightGlueMatcher
        from rover_slam_tpu_torch.models.superpoint import SuperPointExtractor
        from rover_slam_tpu_torch.slam import tracking as T

        self.cfg, self.scene, self.frames, self.dev, self.cap = cfg, scene, frames, dev, cap
        sp, lg = cfg["superpoint"], cfg["lightglue"]
        self.hw = tuple(scene.image_hw)
        self.ext = SuperPointExtractor(params=trees["superpoint"],
                                       max_keypoints=sp["max_keypoints"],
                                       nms_radius=sp["nms_radius"],
                                       score_threshold=sp["score_threshold"], device=dev)
        self.matcher = MatcherProxy(LightGlueFrameMatcher(
            LightGlueMatcher(params=trees["lightglue"], num_layers=lg["layers"], dim=lg["dim"],
                             threshold=lg["threshold"], device=dev), self.hw), cap)
        tr = cfg["tracker"]
        self.tracker_cfg = T.TrackerConfig(image_hw=self.hw, **tr)
        self.cam = torch.as_tensor(scene.cam, device=dev)
        self.slam = self.new_slam()

    def loop_config(self):
        from rover_slam_tpu_torch.slam.loop_closing import LoopConfig
        return LoopConfig(**self.cfg["loop"]) if "loop" in self.cfg else None

    def new_slam(self):
        from rover_slam_tpu_torch.slam.system import MonocularSLAM
        c = self.cfg["capacities"]
        return MonocularSLAM(self.scene.cam, config=self.tracker_cfg,
                             map_capacity=(c["keyframes"], c["keypoints"], c["landmarks"]),
                             desc_dim=self.cfg["superpoint"]["desc_dim"],
                             pipeline=self.cfg["pipeline"],
                             enable_loop_closing="loop" in self.cfg,
                             loop_config=self.loop_config(), matcher=self.matcher,
                             device=self.dev)

    def image(self, i: int) -> torch.Tensor:
        """Frame i as the camera hands it over (uint8 on the host), on the
        device as float32 in [0, 1]: [1, H, W]."""
        return torch.from_numpy(self.frames[i]).to(self.dev).float().div_(255.0)[None]

    def extract(self, i: int):
        """SuperPoint on frame i; the sampled frames' outputs are kept."""
        cap = self.cap
        image = self.image(i)
        with cap.span("superpoint"):
            out = self.ext(image)
        if cap.draw("superpoint"):
            cap.keep("superpoint", image=image[0],
                     **{k: v[0].clone() for k, v in out.items()})
        return out

    def track(self, slam, i: int, out):
        from rover_slam_tpu_torch.geometry import cameras
        kpts = out["keypoints"][0]
        rays = cameras.unproject(cameras.PINHOLE, self.cam, kpts)
        return slam.track_frame(kpts, rays, out["descriptors"][0], out["valid"][0],
                                float(self.scene.times[i]))

    def frame(self, i: int, slam=None):
        info = self.track(slam or self.slam, i, self.extract(i))
        sync(self.dev)
        return info

    def warm_up(self, n: int = 2):
        """Allocator pools, cuDNN and cuBLAS plans, on a throw-away system."""
        warm = self.new_slam()
        for i in range(n):
            self.frame(i, slam=warm)

    def before_window(self):
        if self.slam.pipeline:
            self.slam.flush()
        self.slam.precompile()
        sync(self.dev)

    def after_window(self):
        self.slam.flush()
        sync(self.dev)

    def outcome(self, window_frames: list, n_loops: int) -> dict:
        """What the window's frames came to: each frame's logged state, the
        estimated camera centres of the OK ones (after the map's final
        corrections) beside the ground truth, and the loops closed in the
        window and since the system started."""
        from rover_slam_tpu_torch.slam import tracking as T
        from slambench.reference.trajectory import centres
        slam, scene = self.slam, self.scene
        est_t, est_R, est_tcw = slam.get_trajectory()
        state_at = {round(float(e[0]), 6): e[3] == T.OK for e in slam.trajectory}
        times = [round(float(scene.times[i]), 6) for i in window_frames]
        ok = [bool(state_at.get(t, False)) for t in times]
        est_c = centres(est_R, est_tcw) if len(est_t) else np.zeros((0, 3))
        row_of = {round(float(t), 6): j for j, t in enumerate(est_t)}
        gt_c = centres(scene.R_cw, scene.t_cw)
        pairs = [(row_of[t], i) for t, i, o in zip(times, window_frames, ok)
                 if o and t in row_of and np.isfinite(est_c[row_of[t]]).all()]
        return {"states_ok": ok, "est": est_c[[p[0] for p in pairs]] if pairs else np.zeros((0, 3)),
                "gt": gt_c[[p[1] for p in pairs]] if pairs else np.zeros((0, 3)),
                "n_loops": n_loops, "loops_total": len(slam.loop_events),
                "n_kf": int(slam.n_kf),
                "summary": {"tracked": sum(ok), "frames": len(ok), "n_kf": int(slam.n_kf),
                            "loops_in_window": n_loops,
                            "loops_total": len(slam.loop_events)}}

    def release(self):
        self.slam = None
