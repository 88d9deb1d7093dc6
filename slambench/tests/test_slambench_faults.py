"""`correct` comes out false when the timed path is broken underneath: the
rest of a run (the tiny CPU cell, the card's look skipped) with one fault
planted in the port, once for each fault the cell can have. The cell runs
on one chip with a batch of one frame: its batches are the keypoints of a
frame and the rows LightGlue matches; there is no exchange between chips."""
import pytest

from slambench.tests import tiny

FAULTS = {
    # a step that returns its state unchanged: after the warm-up frames,
    # track_frame returns the previous frame's info and does nothing
    "state_unchanged": """
from rover_slam_tpu_torch.slam import system as S
_tf = S.MonocularSLAM.track_frame
def track_frame(self, *a, **k):
    self._calls = getattr(self, "_calls", 0) + 1
    if self._calls > 20 and getattr(self, "_last", None) is not None:
        return self._last
    self._last = _tf(self, *a, **k)
    return self._last
S.MonocularSLAM.track_frame = track_frame
""",
    # half of the batch left out: every other keypoint of a frame marked invalid
    "half_keypoints_left_out": """
from rover_slam_tpu_torch.models import superpoint as SP
_call = SP.SuperPointExtractor.__call__
def call(self, images):
    out = _call(self, images)
    out["valid"][..., ::2] = False
    return out
SP.SuperPointExtractor.__call__ = call
""",
    # an answer altered where it is produced: SuperPoint's descriptors
    "descriptors_altered": """
import torch
from rover_slam_tpu_torch.models import superpoint as SP
_call = SP.SuperPointExtractor.__call__
def call(self, images):
    out = _call(self, images)
    d = out["descriptors"]
    out["descriptors"] = torch.nn.functional.normalize(d + 0.2 * torch.roll(d, 1, dims=-1), dim=-1)
    return out
SP.SuperPointExtractor.__call__ = call
""",
    # an answer altered where it is produced: LightGlue's matches
    "matches_altered": """
import torch
from rover_slam_tpu_torch.models import lightglue as LG
_call = LG.LightGlueMatcher.__call__
def call(self, *a):
    out = _call(self, *a)
    m = out["matches0"]
    n1 = a[3].shape[1]
    out["matches0"] = torch.where(m >= 0, (m + 1) % n1, m).to(m.dtype)
    return out
LG.LightGlueMatcher.__call__ = call
""",
    # an answer altered where it is produced: B2's argmin
    "nn_argmin_altered": """
from rover_slam_tpu_torch.ops import nn_matcher as NM
_red = NM.nn_reduce
def nn_reduce(d0, d1, v1):
    best, idx, second = _red(d0, d1, v1)
    return best, (idx + 1) % d1.shape[0], second
NM.nn_reduce = nn_reduce
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(tmp_path, fault):
    root = tiny.checkout(str(tmp_path))
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(), prelude=FAULTS[fault])
    assert code == 0, err[-3000:]
    assert last["correct"] is False, last["checks"]
