"""track_syncs_per_frame: implicit host syncs of the tracker in the traced
stretch, per frame of the stretch. Each sync counts against the innermost
program span open at the time (its "<span>/syncs" samples), so the
tracker's are those of lm_track and of the spans it opens itself: track.*
and pose_opt (relocalization's PnP calls pose_opt too; no cell loses
tracking). lm_track's own samples alone hold one sync a frame."""
from slambench.record import per_stretch_frame

SPANS = ("lm_track", "track.match", "track.motion", "track.ref_kf", "track.local_map",
         "pose_opt")


def read(rec: dict):
    n = [v for f in rec["frames"] if f["profiled"] for s in SPANS
         for v in (f["stages"] or {}).get(s + "/syncs", [])]
    return per_stretch_frame(rec, sum(n)) if n else None
