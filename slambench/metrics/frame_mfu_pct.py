"""frame_mfu_pct: the networks' operations a frame (SuperPoint on each of the
frame's images_per_frame images, LightGlue at the (B, N, M) of every call
the frame made) over the frame's time at the card's bf16 dense peak, over
the unprofiled frames of the window, in %. Geometry and the solvers are
left out, so this bounds the kernels' rooflines from above only for the
networks."""
from slambench import flops
from slambench.record import unprofiled


def read(rec: dict):
    frames = unprofiled(rec)
    if not frames:
        return None
    ids = {f["i"] for f in frames}
    h, w = rec["image_hw"]
    lg = rec["config"]["lightglue"]
    ops = len(frames) * rec["images_per_frame"] * flops.superpoint_flops(h, w)
    ops += sum(flops.lightglue_flops(b, n, m, lg["dim"], lg["layers"])
               for fr, b, n, m, prof in rec["lightglue_calls"] if fr in ids and not prof)
    seconds = sum(f["ms"] for f in frames) / 1e3
    return 100.0 * ops / (seconds * flops.PEAK_BF16_FLOPS)
