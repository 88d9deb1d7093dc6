"""Slot recycling in the port against the JAX package, synchronous mode:
the tracker settings of tests/test_map_lifecycle.py's compaction scenes
(cull every 3 keyframes, a keyframe at least every 4 frames) on tables small
enough that both run out (16 keyframes, 2048 landmarks), on the synthetic
forward scene (512 keypoints, 64 frames; the lifecycle test's own
256-keypoint scene does not initialize before frame ~75 in either package).
Landmark pressure compacts the tables repeatedly and the full keyframe table
sheds its oldest keyframes through culling and compaction. Both systems must
track after init, create more keyframes than the table holds, drop no
landmark, and keep trajectories whose ATEs agree within 1 cm (under the
lifecycle test's 20 cm); keyframe counts within 30 %."""
from torch_parity import check_compaction_scene, run_compaction_scene


def test_tables_recycle_like_the_reference():
    check_compaction_scene(run_compaction_scene(pipeline=0, n_frames=64))
