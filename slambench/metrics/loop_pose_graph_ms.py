"""loop_pose_graph_ms: the loop correction's essential-graph optimisation
(the program's "loop.pose_graph" span: _correct_loop_kernel on
optim/pose_graph.py) on the window's first unprofiled frame that ran one, in
ms. Host-inclusive and unsynced, as track_ms."""
from slambench.record import unprofiled


def read(rec: dict):
    return next((f["stages"]["loop.pose_graph"][0] for f in unprofiled(rec)
                 if (f["stages"] or {}).get("loop.pose_graph")), None)
