"""attention_roofline_pct: kernel B1 (csrc/flash_attention.cu) in the traced
stretch: the least time its calls could take (flops.least_seconds over each
attention call of each LightGlue forward the stretch ran) over the device
time of the kernels named here, in %."""
from slambench import flops
from slambench.record import device_us

KERNELS = ("flash_tc_kernel", "flash_kernel")


def read(rec: dict):
    dev = device_us(rec, KERNELS) / 1e6
    lg = rec["config"]["lightglue"]
    least = sum(flops.least_seconds(flops.attention_call_flops(*c),
                                    flops.attention_call_bytes(*c))
                for _, b, n, m, prof in rec["lightglue_calls"] if prof
                for c in flops.lightglue_attention_calls(b, n, m, lg["dim"], lg["layers"]))
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev
