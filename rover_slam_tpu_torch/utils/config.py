"""Session set-up helpers (counterpart of rover_slam_tpu/utils/config.py;
its YAML config reader and build_system come with the persistence slice)."""
from __future__ import annotations

import numpy as np

from ..map import atlas
from ..map import keyframe_database as kdb


def resume_atlas(slam, state):
    """Continue from a stored map state: its keyframes get uids and enter
    the place-recognition database, and tracking starts a fresh Atlas map,
    which a cross-map detection later welds to the stored ones."""
    slam.state = atlas.create_new_map(state)
    slam.n_kf = int(slam.state.n_kf)
    act = slam.state.kf_active.cpu().numpy()
    for s in np.nonzero(act[:slam.n_kf])[0]:
        slam._assign_uid(int(s))
    if slam.loop_closer is not None:
        st = slam.state
        slam.loop_closer.db = kdb.db_build_from_state(slam.loop_closer.db, st.kf_desc,
                                                      st.kf_kpt_valid, st.kf_active)
    return slam
