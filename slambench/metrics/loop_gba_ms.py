"""loop_gba_ms: the post-loop global BA (the program's "loop.gba" span:
map/maintenance.py::global_ba, one chunk on the fire and one a frame after
it): the sum of its samples from the window's first unprofiled frame that
ran a loop correction ("loop.pose_graph") through the last chunk, in ms.
None when the chunks ran past the unprofiled frames. Host-inclusive and
unsynced, as track_ms."""
from slambench.record import unprofiled


def read(rec: dict):
    frames = [f["stages"] or {} for f in unprofiled(rec)]
    first = next((k for k, st in enumerate(frames) if st.get("loop.pose_graph")), None)
    if first is None:
        return None
    total = 0.0
    for k, st in enumerate(frames[first:]):
        if not st.get("loop.gba") or (k > 0 and st.get("loop.pose_graph")):
            return total if k > 0 else None
        total += sum(st["loop.gba"])
    return None
