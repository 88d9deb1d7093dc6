"""LightGlue feature matcher: rotary-position transformer with a double-softmax
log-assignment and a matchability dustbin.

Counterpart of rover_slam_tpu/models/lightglue.py. Every attention call goes
through `ops.flash_attention.masked_attention`, i.e. the hand-written CUDA
kernel at every N on the card (the JAX package only switches to its Pallas
kernel from 2048 keypoints). Flax defaults are pinned: LayerNorm eps 1e-6,
tanh-approximate GELU, pairwise rotary layout.

Dtypes. Every Dense of the layer stack (input_proj and the transformer
layers) computes in `dtype` (bf16 on the main path): its input and its
parameters are cast to `dtype` for each call, as a Flax Dense with `dtype=`
does. Positional encoding, the assignment head, matchability and the
LayerNorm statistics and affine are f32.
- Serving (LightGlueMatcher): `to_compute_dtype()` casts the layer stack's
  Dense parameters to `dtype` once, so the per-call cast is a no-op; the
  outputs are the training forward's to the bit.
- Training (training/lightglue_train.py): the parameters stay f32, as Flax
  keeps them, the optimizer updates them in f32, and each call casts them;
  gradients reach them through the casts and through the attention kernel
  (ops.flash_attention.KernelAttention).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.flash_attention import masked_attention
from ..utils import profiling
from . import weights as W

NEG_INF = -1e9


def normalize_keypoints(kpts: torch.Tensor, image_hw) -> torch.Tensor:
    """Pixel coords -> [-1, 1] by image centre and half the larger side."""
    h, w = image_hw
    center = torch.tensor([w / 2.0, h / 2.0], dtype=kpts.dtype, device=kpts.device)
    return (kpts - center) / (max(h, w) / 2.0)


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """Dense computing in `dtype` (the Flax `dtype=` semantics)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


class LearnableFourierPE(nn.Module):
    """Positions [B,N,2] -> rotary (cos, sin), each [B,N,head_dim], every
    frequency repeated twice (pairwise layout)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, pos):
        f = _linear(self.Wr, pos, torch.float32)
        return (torch.repeat_interleave(torch.cos(f), 2, dim=-1),
                torch.repeat_interleave(torch.sin(f), 2, dim=-1))


def rotate_half(x):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(x, cos, sin):
    """x [B,N,H,Dh], cos/sin [B,N,Dh]."""
    return x * cos[:, :, None, :] + rotate_half(x) * sin[:, :, None, :]


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x_q, x_kv, mask_kv, rope_q=None, rope_k=None):
        B, Nq, dim = x_q.shape
        Nk = x_kv.shape[1]
        H = self.num_heads
        Dh = dim // H
        q = _linear(self.to_q, x_q, self.dtype).reshape(B, Nq, H, Dh)
        k = _linear(self.to_k, x_kv, self.dtype).reshape(B, Nk, H, Dh)
        v = _linear(self.to_v, x_kv, self.dtype).reshape(B, Nk, H, Dh)
        if rope_q is not None:
            q = apply_rotary(q, *rope_q)
            k = apply_rotary(k, *rope_k)
        out = masked_attention(q, k, v, mask_kv)
        return _linear(self.to_out, out.reshape(B, Nq, dim), self.dtype)


class ConcatFFN(nn.Module):
    """x + MLP([x, message]) with LayerNorm (eps 1e-6, f32) and tanh GELU."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(2 * dim, 2 * dim)
        self.ln = nn.LayerNorm(2 * dim, eps=1e-6)
        self.fc2 = nn.Linear(2 * dim, dim)

    def forward(self, x, message):
        y = _linear(self.fc1, torch.cat([x, message], dim=-1), self.dtype)
        y = F.layer_norm(y.float(), self.ln.normalized_shape, self.ln.weight,
                         self.ln.bias, self.ln.eps).to(x.dtype)
        y = F.gelu(y, approximate="tanh")
        return x + _linear(self.fc2, y, self.dtype)


class TransformerLayer(nn.Module):
    """Self-attention (rotary) then cross-attention, each followed by a
    concat-FFN; weights shared across the two images."""

    def __init__(self, dim: int, num_heads: int, dtype):
        super().__init__()
        self.self_attn = Attention(dim, num_heads, dtype)
        self.self_ffn = ConcatFFN(dim, dtype)
        self.cross_attn = Attention(dim, num_heads, dtype)
        self.cross_ffn = ConcatFFN(dim, dtype)

    def forward(self, d0, d1, rope0, rope1, m0, m1):
        s0 = self.self_attn(d0, d0, m0, rope_q=rope0, rope_k=rope0)
        s1 = self.self_attn(d1, d1, m1, rope_q=rope1, rope_k=rope1)
        d0 = self.self_ffn(d0, s0)
        d1 = self.self_ffn(d1, s1)
        c0 = self.cross_attn(d0, d1, m1)
        c1 = self.cross_attn(d1, d0, m0)
        return self.cross_ffn(d0, c0), self.cross_ffn(d1, c1)


class LightGlue(nn.Module):
    def __init__(self, dim: int = 256, num_heads: int = 4, num_layers: int = 9,
                 desc_dim: int = 256, dtype=torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.input_proj = nn.Linear(desc_dim, dim)
        self.posenc = LearnableFourierPE(dim // num_heads)
        self.layers = nn.ModuleList(TransformerLayer(dim, num_heads, dtype)
                                    for _ in range(num_layers))
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)

    def to_compute_dtype(self):
        """Serving: cast the Dense parameters of the layer stack to `dtype`
        once. Posenc, the assignment head and the LayerNorm affine
        parameters stay f32 (cast to bf16 and back, a LayerNorm scale would
        lose its low bits, which Flax keeps). The outputs are those of the
        f32 parameters cast per call."""
        for m in (self.input_proj, *self.layers.modules()):
            if isinstance(m, nn.Linear):
                m.to(self.dtype)
        return self

    def forward(self, kpts0, desc0, mask0, kpts1, desc1, mask1):
        """kpts [B,N,2] in [-1,1]; desc [B,N,256]; mask [B,N] bool. Returns
        (log_assignment [B,N0+1,N1+1], matchability0 [B,N0], matchability1)."""
        with profiling.span("lg.layers", sample=False):
            d0 = _linear(self.input_proj, desc0, self.dtype)
            d1 = _linear(self.input_proj, desc1, self.dtype)
            rope0 = tuple(r.to(self.dtype) for r in self.posenc(kpts0.float()))
            rope1 = tuple(r.to(self.dtype) for r in self.posenc(kpts1.float()))
            for layer in self.layers:
                d0, d1 = layer(d0, d1, rope0, rope1, mask0, mask1)
        with profiling.span("lg.assign", sample=False):
            scale = float(self.dim) ** 0.25
            md0 = _linear(self.final_proj, d0.float(), torch.float32) / scale
            md1 = _linear(self.final_proj, d1.float(), torch.float32) / scale
            sim = torch.einsum("bmd,bnd->bmn", md0, md1)
            sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim, NEG_INF)
            z0 = _linear(self.matchability, d0.float(), torch.float32)[..., 0]
            z1 = _linear(self.matchability, d1.float(), torch.float32)[..., 0]
            scores0 = F.log_softmax(sim, dim=2)
            scores1 = F.log_softmax(sim, dim=1)
            cert = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
            B, N0, N1 = sim.shape
            la = sim.new_zeros((B, N0 + 1, N1 + 1))
            la[:, :N0, :N1] = scores0 + scores1 + cert
            la[:, :N0, N1] = F.logsigmoid(-z0)
            la[:, N0, :N1] = F.logsigmoid(-z1)
            return la, torch.sigmoid(z0), torch.sigmoid(z1)


@profiling.spanned("lg.assign", sample=False)
def extract_matches(log_assignment, mask0, mask1, threshold: float = 0.0) -> dict:
    """Mutual-argmax matches: matches0 [B,N0] int32 (-1 unmatched),
    mscores0 [B,N0]."""
    B, N0p, N1p = log_assignment.shape
    N0 = N0p - 1
    scores = torch.exp(log_assignment[:, :N0, :N1p - 1])
    scores = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, 0.0)
    best1 = torch.argmax(scores, dim=2)
    best0 = torch.argmax(scores, dim=1)
    sc = torch.gather(scores, 2, best1[:, :, None])[..., 0]
    mutual = torch.gather(best0, 1, best1) == torch.arange(N0, device=scores.device)[None, :]
    ok = mutual & (sc > threshold) & mask0
    return {"matches0": torch.where(ok, best1, -1).to(torch.int32),
            "mscores0": torch.where(ok, sc, 0.0)}


class LightGlueMatcher:
    """Batched matching on one device. params: the JAX package's parameter
    tree (nested dicts of numpy arrays) or None for random weights from
    torch seed 1; device None means cuda."""

    def __init__(self, params=None, num_layers: int = 9, dim: int = 256,
                 threshold: float = 0.0, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.threshold = threshold
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            model = LightGlue(dim=dim, num_layers=num_layers, dtype=dtype)
        if params is not None:
            model.load_state_dict(W.lightglue_state_dict(params, num_layers))
        self.model = model.to_compute_dtype().to(self.device).eval()

    @torch.no_grad()
    def __call__(self, kpts0, desc0, mask0, kpts1, desc1, mask1) -> dict:
        la, _, _ = self.model(kpts0, desc0, mask0, kpts1, desc1, mask1)
        return extract_matches(la, mask0, mask1, self.threshold)


class LightGlueFrameMatcher:
    """LightGlue as the tracker's frame-to-frame matcher: pixel keypoints,
    descriptors and valid masks of two frames in, [N] int32 prev->cur match
    indices out (-1 unmatched)."""

    def __init__(self, matcher: LightGlueMatcher, image_hw):
        self.matcher = matcher
        self.image_hw = tuple(image_hw)

    def __call__(self, kpts0, desc0, valid0, kpts1, desc1, valid1):
        return self.match_batch(kpts0[None], desc0[None], valid0[None],
                                kpts1[None], desc1[None], valid1[None])[0]

    def match_batch(self, kpts0, desc0, valid0, kpts1, desc1, valid1):
        """[B,N,...] inputs -> [B,N] int32 matches (0->1), one call for all
        B pairs."""
        k0 = normalize_keypoints(kpts0, self.image_hw)
        k1 = normalize_keypoints(kpts1, self.image_hw)
        return self.matcher(k0, desc0, valid0, k1, desc1, valid1)["matches0"]


def load_torch_weights(path: str, num_layers: int = 9, dim: int = 256) -> dict:
    """The official LightGlue checkpoint (github.com/cvg/LightGlue
    `superpoint_lightglue.pth`: weights under `transformers.{i}.self_attn /
    cross_attn`) as the parameter tree LightGlueMatcher takes (the JAX
    package's layout, numpy float32). The self block's fused `Wqkv` [3D, D]
    splits into to_q / to_k / to_v; the cross block's shared `to_qk` serves as
    both to_q and to_k; each `ffn` Sequential(Linear, LayerNorm, GELU,
    Linear) becomes fc1 / ln / fc2; only the last layer's `log_assignment`
    head is read (no early exit)."""
    import numpy as np
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()

    def t(name):   # Linear weight [out, in] -> kernel [in, out]
        return np.ascontiguousarray(np.asarray(sd[name], np.float32).T)

    def v(name):
        return np.asarray(sd[name], np.float32)

    def dense(prefix):
        return {"kernel": t(f"{prefix}.weight"), "bias": v(f"{prefix}.bias")}

    def ffn(prefix):
        return {"fc1": dense(f"{prefix}.ffn.0"),
                "ln": {"scale": v(f"{prefix}.ffn.1.weight"), "bias": v(f"{prefix}.ffn.1.bias")},
                "fc2": dense(f"{prefix}.ffn.3")}

    last = f"log_assignment.{num_layers - 1}"
    params = {"input_proj": dense("input_proj"),
              "posenc": {"Wr": {"kernel": t("posenc.Wr.weight")}},
              "final_proj": dense(f"{last}.final_proj"),
              "matchability": dense(f"{last}.matchability")}
    for i in range(num_layers):
        p = f"transformers.{i}"
        Wqkv, bqkv = t(f"{p}.self_attn.Wqkv.weight"), v(f"{p}.self_attn.Wqkv.bias")
        qk = dense(f"{p}.cross_attn.to_qk")
        params[f"layer_{i}"] = {
            "self_attn": {
                **{n: {"kernel": Wqkv[:, j * dim:(j + 1) * dim],
                       "bias": bqkv[j * dim:(j + 1) * dim]}
                   for j, n in enumerate(("to_q", "to_k", "to_v"))},
                "to_out": dense(f"{p}.self_attn.out_proj")},
            "self_ffn": ffn(f"{p}.self_attn"),
            "cross_attn": {"to_q": qk, "to_k": qk, "to_v": dense(f"{p}.cross_attn.to_v"),
                           "to_out": dense(f"{p}.cross_attn.to_out")},
            "cross_ffn": ffn(f"{p}.cross_attn")}
    return params
