"""PyTorch / CUDA port of rover_slam_tpu for one NVIDIA H100.

The JAX package (`rover_slam_tpu/`) is the reference; this package mirrors its
layout module by module and never imports it. Hand-written CUDA kernels live
in `csrc/` and are built with nvcc at first use (see `ops/_build.py`).
"""
import torch

__version__ = "0.1.0"

# Geometry and optimization need true f32 products: the counterpart of the
# JAX package's jax_default_matmul_precision="highest". The networks opt into
# bf16 explicitly where the JAX package does.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.
    None means cuda; asking for cuda without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rover_slam_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev
