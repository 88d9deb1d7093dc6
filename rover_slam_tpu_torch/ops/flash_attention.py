"""Masked attention for LightGlue: a hand-written CUDA kernel and its plain
PyTorch twin.

Counterpart of rover_slam_tpu/ops/pallas_attention.py::masked_attention (TPU
kernel `_flash_kernel`). `masked_attention(q, k, v, mask_kv)` computes
softmax(q k^T / sqrt(Dh), masked over kv) v for q, k, v [B, N, H, Dh] and
mask_kv [B, Nk] bool. As in the JAX package, 1/sqrt(Dh) is folded into q in
q's dtype before anything else, so kernel and plain version round at the
same place. A row whose kv is all masked returns the mean of v over Nk (the
JAX package's XLA path; its Pallas kernel would average over the padded kv).

Routing: a CPU tensor goes to `masked_attention_plain`; a CUDA tensor goes to
the kernel in csrc/flash_attention.cu or the call raises. bf16 (the main
path) runs on the tensor cores, with the softmax weights P carried as two
bf16 terms (hi + lo) where the plain version rounds them to bf16 once; f32
runs on the CUDA cores.

Gradients: the kernel has no backward. When q, k or v requires a gradient
on the card, the call goes through `KernelAttention`, whose forward is the
same launch and whose backward recomputes `masked_attention_plain` on the
saved inputs and differentiates it: the gradient the JAX package takes
(XLA's autodiff of the same plain path; its Pallas kernel is never
differentiated). On the CPU autograd runs through the plain version itself.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils import profiling
from . import _build

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
# The bf16 kernel keeps one mask byte per key in shared memory.
MAX_KV_BF16 = 131072

# Counters of utils/profiling.py's registry: kernel launches, in all
# ("attention_launches") and by batch size B ("launches_by_batch"), and the
# backward recomputes of KernelAttention ("backward_recomputes", one for
# each launch whose output was differentiated).


def _scale_q(q: torch.Tensor) -> torch.Tensor:
    Dh = q.shape[-1]
    return q / torch.tensor(math.sqrt(Dh), dtype=torch.float32).to(q.dtype)


def masked_attention_plain(q, k, v, mask_kv):
    """Plain PyTorch version (the JAX package's XLA path)."""
    q = _scale_q(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    s = torch.where(mask_kv[:, None, None, :], s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@profiling.spanned("b1.attention", sample=False)
def masked_attention(q, k, v, mask_kv):
    """softmax(q k^T / sqrt(Dh), masked over kv) @ v; [B, Nq, H, Dh] out."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, mask_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return KernelAttention.apply(q, k, v, mask_kv)
    return _launch(_scale_q(q), k, v, mask_kv)


class KernelAttention(torch.autograd.Function):
    """Forward: the kernel launch of `masked_attention`. Backward: autograd
    of `masked_attention_plain`, recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kv):
        ctx.save_for_backward(q, k, v, mask_kv)
        return _launch(_scale_q(q), k, v, mask_kv)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask_kv = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        ins = [x.detach().requires_grad_(n) for x, n in zip((q, k, v), need)]
        with torch.enable_grad():
            out = masked_attention_plain(*ins, mask_kv)
            got = iter(torch.autograd.grad(out, [x for x in ins if x.requires_grad],
                                           grad_out))
        profiling.count("backward_recomputes")
        return tuple(next(got) if n else None for n in need) + (None,)


def _launch(q, k, v, mask_kv):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (k.device == v.device == mask_kv.device == q.device):
        raise ValueError("flash_attention: q, k, v and mask on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                         " (needs all float32 or all bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q, k, v must be [B, N, H, Dh]")
    B, Nq, H, Dh = q.shape
    Nk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not in {_HEAD_DIMS}")
    if mask_kv.dtype != torch.bool or tuple(mask_kv.shape) != (B, Nk):
        raise ValueError("flash_attention: mask_kv must be bool [B, Nk]")
    if Nq == 0 or Nk == 0:
        raise ValueError("flash_attention: empty query or kv")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dimension must be contiguous")
    if q.dtype == torch.bfloat16:
        if Nk > MAX_KV_BF16:
            raise ValueError(f"flash_attention: Nk {Nk} > {MAX_KV_BF16} (shared memory)")
        q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    mask_kv = mask_kv.contiguous()
    out = torch.empty((B, Nq, H, Dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 13)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        mask_kv.stride(0),
        out.stride(0), out.stride(1), out.stride(2))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_kv.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], B, H, Nq, Nk, Dh, strides, stream)
    _build.check(status, "flash_attention")
    profiling.count("attention_launches")
    profiling.count("launches_by_batch", B)
    return out


def _aligned16(x):
    """x itself if the tensor-core route can copy its rows in 16-byte pieces
    (16-byte aligned, b/n/h strides multiples of 8 elements), else a fresh
    contiguous copy."""
    if x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
