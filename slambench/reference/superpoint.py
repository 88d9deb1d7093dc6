"""SuperPoint, plain: the detector and descriptor forward in float32 (TF32
off) and the keypoint extraction (NMS, border, top-K, threshold, bilinear
descriptor sampling at cell centres 8i + 3.5), as the port's
models/superpoint.py defines them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import rnd

CELL = 8
LAYERS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b")


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class SuperPointRef:
    def __init__(self, tree: dict, device, precision: str = "f32"):
        """tree: reference.weights.load_npz of superpoint_synth.npz."""
        self.precision = precision
        self.w = {}
        for name in LAYERS + ("convPa", "convPb", "convDa", "convDb"):
            leaf = tree[name].get("conv", tree[name])
            k = torch.as_tensor(leaf["kernel"]).permute(3, 2, 0, 1).contiguous()
            self.w[name] = (k.to(device), torch.as_tensor(leaf["bias"]).to(device))

    def _conv(self, name, x):
        k, b = self.w[name]
        return F.conv2d(rnd(x, self.precision), rnd(k, self.precision), b,
                        padding=k.shape[-1] // 2)

    @torch.no_grad()
    def dense(self, image: torch.Tensor):
        """image [H, W] in [0, 1] -> (prob [H, W], unit descriptors
        [H/8, W/8, 256])."""
        tf32_off()
        x = image.float()[None, None]
        for i, name in enumerate(LAYERS):
            x = F.relu(self._conv(name, x))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        logits = self._conv("convPb", F.relu(self._conv("convPa", x)))[0]   # [65,Hc,Wc]
        prob = torch.softmax(logits, dim=0)[:64]
        _, Hc, Wc = prob.shape
        prob = prob.reshape(CELL, CELL, Hc, Wc).permute(2, 0, 3, 1).reshape(Hc * CELL, Wc * CELL)
        desc = self._conv("convDb", F.relu(self._conv("convDa", x)))[0].permute(1, 2, 0)
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)
        return prob, desc


def sample_descriptors(desc_coarse: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [Hc, Wc, D] unit descriptors at pixel keypoints
    [K, 2] (x, y), renormalized."""
    Hc, Wc, D = desc_coarse.shape
    gx = torch.clamp((kpts[:, 0] - (CELL - 1) / 2.0) / CELL, 0.0, Wc - 1.0)
    gy = torch.clamp((kpts[:, 1] - (CELL - 1) / 2.0) / CELL, 0.0, Hc - 1.0)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    x1, y1 = torch.clamp(x0 + 1, max=Wc - 1), torch.clamp(y0 + 1, max=Hc - 1)
    wx, wy = (gx - x0)[:, None], (gy - y0)[:, None]
    d = (desc_coarse[y0, x0] * (1 - wx) * (1 - wy) + desc_coarse[y0, x1] * wx * (1 - wy)
         + desc_coarse[y1, x0] * (1 - wx) * wy + desc_coarse[y1, x1] * wx * wy)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)


def extract(prob: torch.Tensor, desc_coarse: torch.Tensor, max_keypoints: int,
            nms_radius: int, score_threshold: float, border: int = 4) -> dict:
    """NMS, border, top-K and descriptor sampling of one image; "nms" is
    the score map after NMS and the border."""
    H, W = prob.shape
    pooled = F.max_pool2d(prob[None, None], 2 * nms_radius + 1, stride=1,
                          padding=nms_radius)[0, 0]
    nms = torch.where(prob == pooled, prob, 0.0)
    ys = torch.arange(H, device=prob.device)[:, None]
    xs = torch.arange(W, device=prob.device)[None, :]
    inside = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    nms = torch.where(inside, nms, 0.0)
    scores, idx = torch.topk(nms.reshape(-1), max_keypoints)
    kpts = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return {"keypoints": kpts, "scores": scores,
            "descriptors": sample_descriptors(desc_coarse, kpts),
            "valid": scores > score_threshold, "nms": nms}
