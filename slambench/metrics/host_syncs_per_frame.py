"""host_syncs_per_frame: implicit host syncs in the traced stretch, as
torch.cuda.set_sync_debug_mode("warn") reports them, per frame."""
from slambench.record import per_stretch_frame


def read(rec: dict):
    return per_stretch_frame(rec, rec["trace"]["syncs"])
