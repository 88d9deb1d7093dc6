"""Slot compaction with the loop closer on (the port alone): the compaction
scene of tests/test_torch_system_compaction.py (16 keyframe slots, culling
every 3 keyframes; 48 frames, two compactions at least) with loop closing
enabled. After every compaction the
place-recognition database must hold, at each live slot, the bag of words of
the keyframe now in that slot and nothing at the others; queued detections
are dropped; and an open hypothesis follows its keyframes to their new slots
(or is dropped with them)."""
import numpy as np
import torch

from rover_slam_tpu_torch.map import keyframe_database as kdb
from rover_slam_tpu_torch.slam import tracking as T
from rover_slam_tpu_torch.slam.system import MonocularSLAM

from torch_parity import COMPACTION_CFG, COMPACTION_K, feed, synthetic_frames


def test_compaction_keeps_database_and_hypothesis():
    world, frames, _ = synthetic_frames(48)
    slam = MonocularSLAM(world.cam_params, map_capacity=(COMPACTION_K, 512, 2048),
                         desc_dim=64, config=T.TrackerConfig(**COMPACTION_CFG),
                         enable_loop_closing=True, device="cpu")
    lc = slam.loop_closer
    checks = []
    compact = slam._compact_map

    def checked():
        # An open hypothesis between the two oldest live keyframes, by uid.
        live = np.nonzero(slam._uid_of_slot >= 0)[0]
        a, b = int(live[0]), int(live[-1])
        uid_a, uid_b = int(slam._uid_of_slot[a]), int(slam._uid_of_slot[b])
        one = torch.ones(())
        lc._hyp = {"cand": a, "q_last": b, "count": 1, "misses": 0, "s": one,
                   "R": torch.eye(3), "t": torch.zeros(3), "n_inliers": 50}
        compact()
        st = slam.state
        act = st.kf_active.numpy()
        np.testing.assert_array_equal(lc.db.active.numpy(), act)
        tf = kdb.bow_transform(lc.db.vocab, st.kf_desc.float(), st.kf_kpt_valid)
        np.testing.assert_allclose(lc.db.tf.numpy()[act], tf.numpy()[act], atol=1e-7)
        assert not lc.db.tf.numpy()[~act].any()
        assert not lc._pending_detect and not lc._pending_cand
        hyp = lc._hyp
        slot_of = {int(u): s for s, u in enumerate(slam._uid_of_slot) if u >= 0}
        if uid_a in slot_of and uid_b in slot_of:
            assert (hyp["cand"], hyp["q_last"]) == (slot_of[uid_a], slot_of[uid_b])
        else:
            assert hyp is None
        lc._hyp = None              # the injected hypothesis must not fire
        checks.append(int(slam.n_kf))

    slam._compact_map = checked
    states = feed(slam, frames)
    slam.flush()
    assert len(checks) >= 2, checks
    assert slam.tracking_state == T.OK
    first_ok = states.index(T.OK)
    assert all(s == T.OK for s in states[first_ok:])
    assert int(slam.state.lm_dropped) == 0
    assert len(lc.score_log) > 0      # the keyframes went through place recognition
