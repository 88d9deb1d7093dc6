"""nn_match_roofline_pct: kernel B2 (csrc/nn_matcher.cu) in the traced
stretch: the least time of its reduces (flops.least_seconds of each
(N0, N1, D) the B2 recorder noted) over the device time of the kernels
named here, in %."""
from slambench import flops
from slambench.record import device_us

KERNELS = ("nn_tc_kernel", "nn_merge_kernel")


def read(rec: dict):
    dev = device_us(rec, KERNELS) / 1e6
    least = sum(flops.least_seconds(flops.nn_reduce_flops(n0, n1, d),
                                    flops.nn_reduce_bytes(n0, n1, d))
                for _, n0, n1, d, prof in rec["nn_calls"] if prof)
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
