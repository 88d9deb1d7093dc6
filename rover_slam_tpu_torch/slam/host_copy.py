"""Device -> host copies that do not block the host until it reads them."""
from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A device tensor on its way to the host: the copy into pinned memory
    is queued behind the work already on the stream and an event marks its
    end, so reading it later waits only for that (the JAX package's
    copy_to_host_async). On the CPU it is a plain copy."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def ready(self) -> bool:
        """Whether the copy has landed; never blocks (the JAX package's
        is_ready)."""
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def numpy(self) -> np.ndarray:
        self.wait()
        return self.host.numpy()
