"""LightGlue, plain: the rotary-position transformer (self then cross
attention, each followed by a concat-FFN with LayerNorm eps 1e-6 and tanh
GELU; pairwise rotary layout) and the double-softmax log-assignment with a
matchability dustbin, in float32 with TF32 off, as the port's
models/lightglue.py defines it (whose layer stack runs in bf16 with its
attention on kernel B1)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import rnd
from .superpoint import tf32_off

NEG_INF = -1e9


def normalize_keypoints(kpts: torch.Tensor, image_hw) -> torch.Tensor:
    """Pixels -> [-1, 1] by the image centre and half the larger side."""
    h, w = image_hw
    center = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32, device=kpts.device)
    return (kpts.float() - center) / (max(h, w) / 2.0)


class LightGlueRef:
    def __init__(self, tree: dict, num_layers: int, device, heads: int = 4,
                 precision: str = "f32"):
        """tree: reference.weights.load_npz of lightglue_synth.npz; the
        first num_layers layers are read."""
        self.heads, self.num_layers, self.precision = heads, num_layers, precision

        def t(a):
            return torch.as_tensor(a).to(device)

        def dense(leaf):
            return (t(leaf["kernel"]), t(leaf["bias"]) if "bias" in leaf else None)

        self.input_proj = dense(tree["input_proj"])
        self.Wr = t(tree["posenc"]["Wr"]["kernel"])
        self.final_proj = dense(tree["final_proj"])
        self.matchability = dense(tree["matchability"])
        self.layers = []
        for i in range(num_layers):
            lp = tree[f"layer_{i}"]
            self.layers.append({
                blk: {n: dense(lp[blk][n]) for n in ("to_q", "to_k", "to_v", "to_out")}
                for blk in ("self_attn", "cross_attn")})
            for blk in ("self_ffn", "cross_ffn"):
                self.layers[-1][blk] = {"fc1": dense(lp[blk]["fc1"]), "fc2": dense(lp[blk]["fc2"]),
                                        "ln": (t(lp[blk]["ln"]["scale"]), t(lp[blk]["ln"]["bias"]))}

    def _lin(self, p, x, rounded=True):
        k, b = p
        if rounded:
            y = rnd(x, self.precision) @ rnd(k, self.precision)
        else:
            y = x @ k
        return y if b is None else y + b

    def _rope(self, pos):
        f = pos @ self.Wr
        return (torch.repeat_interleave(torch.cos(f), 2, dim=-1),
                torch.repeat_interleave(torch.sin(f), 2, dim=-1))

    @staticmethod
    def _rotary(x, cos, sin):
        x1, x2 = x[..., 0::2], x[..., 1::2]
        rot = torch.stack([-x2, x1], dim=-1).reshape(x.shape)
        return x * cos[:, :, None, :] + rot * sin[:, :, None, :]

    def _attn(self, p, xq, xkv, mask_kv, rope_q=None, rope_k=None):
        B, Nq, dim = xq.shape
        Nk, H = xkv.shape[1], self.heads
        Dh = dim // H
        q = self._lin(p["to_q"], xq).reshape(B, Nq, H, Dh)
        k = self._lin(p["to_k"], xkv).reshape(B, Nk, H, Dh)
        v = self._lin(p["to_v"], xkv).reshape(B, Nk, H, Dh)
        if rope_q is not None:
            q, k = self._rotary(q, *rope_q), self._rotary(k, *rope_k)
        s = torch.einsum("bqhd,bkhd->bhqk", rnd(q, self.precision) / math.sqrt(Dh),
                         rnd(k, self.precision))
        s = torch.where(mask_kv[:, None, None, :], s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", rnd(a, self.precision), rnd(v, self.precision))
        return self._lin(p["to_out"], o.reshape(B, Nq, dim))

    def _ffn(self, p, x, msg):
        y = self._lin(p["fc1"], torch.cat([x, msg], dim=-1))
        w, b = p["ln"]
        y = F.gelu(F.layer_norm(y, (y.shape[-1],), w, b, 1e-6), approximate="tanh")
        return x + self._lin(p["fc2"], y)

    @torch.no_grad()
    def log_assignment(self, kpts0, desc0, mask0, kpts1, desc1, mask1):
        """kpts [B,N,2] in [-1, 1]; desc [B,N,256]; mask [B,N] bool ->
        log-assignment [B, N0+1, N1+1]."""
        tf32_off()
        d0 = self._lin(self.input_proj, desc0.float())
        d1 = self._lin(self.input_proj, desc1.float())
        r0, r1 = self._rope(kpts0.float()), self._rope(kpts1.float())
        for L in self.layers:
            s0 = self._attn(L["self_attn"], d0, d0, mask0, r0, r0)
            s1 = self._attn(L["self_attn"], d1, d1, mask1, r1, r1)
            d0, d1 = self._ffn(L["self_ffn"], d0, s0), self._ffn(L["self_ffn"], d1, s1)
            c0 = self._attn(L["cross_attn"], d0, d1, mask1)
            c1 = self._attn(L["cross_attn"], d1, d0, mask0)
            d0, d1 = self._ffn(L["cross_ffn"], d0, c0), self._ffn(L["cross_ffn"], d1, c1)
        dim = d0.shape[-1]
        md0 = self._lin(self.final_proj, d0, rounded=False) / dim ** 0.25
        md1 = self._lin(self.final_proj, d1, rounded=False) / dim ** 0.25
        sim = torch.einsum("bmd,bnd->bmn", md0, md1)
        sim = torch.where(mask0[:, :, None] & mask1[:, None, :], sim, NEG_INF)
        z0 = self._lin(self.matchability, d0, rounded=False)[..., 0]
        z1 = self._lin(self.matchability, d1, rounded=False)[..., 0]
        B, N0, N1 = sim.shape
        la = sim.new_zeros((B, N0 + 1, N1 + 1))
        la[:, :N0, :N1] = (F.log_softmax(sim, dim=2) + F.log_softmax(sim, dim=1)
                           + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :])
        la[:, :N0, N1] = F.logsigmoid(-z0)
        la[:, N0, :N1] = F.logsigmoid(-z1)
        return la


def extract_matches(la, mask0, mask1, threshold: float) -> torch.Tensor:
    """Mutual-argmax matches [B, N0] (-1 unmatched) with scores above
    threshold."""
    N0, N1 = la.shape[1] - 1, la.shape[2] - 1
    scores = torch.where(mask0[:, :, None] & mask1[:, None, :], torch.exp(la[:, :N0, :N1]), 0.0)
    best1 = torch.argmax(scores, dim=2)
    best0 = torch.argmax(scores, dim=1)
    sc = torch.gather(scores, 2, best1[:, :, None])[..., 0]
    mutual = torch.gather(best0, 1, best1) == torch.arange(N0, device=la.device)[None]
    return torch.where(mutual & (sc > threshold) & mask0, best1, -1)
