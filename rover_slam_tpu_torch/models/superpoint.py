"""SuperPoint keypoint detector + descriptor, batched and fixed-K.

Counterpart of rover_slam_tpu/models/superpoint.py. The network runs in NCHW
internally; the public functions keep the JAX package's layouts (image
[B,H,W] or [B,H,W,1], dense prob [B,H,W], coarse descriptors
[B,H/8,W/8,256]). Convolutions run in `dtype` (bf16 on the main path, with
f32 accumulation); the detector softmax and descriptor normalization are f32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from . import weights as W

DESC_DIM = 256
CELL = 8

_LAYERS = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64),
           ("conv2b", 64, 64), ("conv3a", 64, 128), ("conv3b", 128, 128),
           ("conv4a", 128, 128), ("conv4b", 128, 128))


class SuperPoint(nn.Module):
    """Returns dense score map [B,H,W] and coarse descriptors [B,Hc,Wc,256]."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in _LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, DESC_DIM, 1)

    def _conv(self, name, x):
        conv = getattr(self, name)
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        padding=conv.padding)

    def forward(self, image):
        """image: [B, H, W, 1] float32 in [0, 1]."""
        x = image.permute(0, 3, 1, 2).to(self.dtype)
        for i, (name, _, _) in enumerate(_LAYERS):
            x = F.relu(self._conv(name, x))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        d = F.relu(self._conv("convPa", x))
        logits = self._conv("convPb", d).float()               # [B,65,Hc,Wc]
        prob = torch.softmax(logits, dim=1)[:, :64]
        B, _, Hc, Wc = prob.shape
        # depth-to-space: channel c = 8*dy + dx -> pixel (8*i + dy, 8*j + dx)
        prob = prob.reshape(B, CELL, CELL, Hc, Wc).permute(0, 3, 1, 4, 2)
        prob = prob.reshape(B, Hc * CELL, Wc * CELL)
        e = F.relu(self._conv("convDa", x))
        desc = self._conv("convDb", e).float().permute(0, 2, 3, 1)   # NHWC
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-8)
        return prob, desc


def simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep scores equal to their (2r+1)^2 local max; scores [B,H,W]."""
    pooled = F.max_pool2d(scores[:, None], kernel_size=2 * radius + 1, stride=1,
                          padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, 0.0)


def sample_descriptors(desc_coarse: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample unit descriptors at pixel keypoints by the explicit
    four-corner gather (cell centres at 8i + 3.5).
    desc_coarse [B,Hc,Wc,D]; kpts [B,K,2] (x, y)."""
    B, Hc, Wc, D = desc_coarse.shape
    gx = torch.clamp((kpts[..., 0] - (CELL - 1) / 2.0) / CELL, 0.0, Wc - 1.0)
    gy = torch.clamp((kpts[..., 1] - (CELL - 1) / 2.0) / CELL, 0.0, Hc - 1.0)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    x1 = torch.clamp(x0 + 1, max=Wc - 1)
    y1 = torch.clamp(y0 + 1, max=Hc - 1)
    wx = gx - x0
    wy = gy - y0
    flat = desc_coarse.reshape(B, Hc * Wc, D)

    def gather(ix, iy):
        idx = (iy * Wc + ix)[..., None].expand(-1, -1, D)
        return torch.gather(flat, 1, idx)

    d = (gather(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
         + gather(x1, y0) * (wx * (1 - wy))[..., None]
         + gather(x0, y1) * ((1 - wx) * wy)[..., None]
         + gather(x1, y1) * (wx * wy)[..., None])
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)


def extract_keypoints(prob, desc_coarse, max_keypoints: int = 1024,
                      nms_radius: int = 4, score_threshold: float = 0.0005,
                      border: int = 4) -> dict:
    """NMS + fixed-K top-K + descriptor sampling. Returns keypoints [B,K,2]
    f32 (x, y), scores [B,K], descriptors [B,K,256], valid [B,K]."""
    B, H, Wd = prob.shape
    nms = simple_nms(prob, nms_radius)
    ys = torch.arange(H, device=prob.device)[None, :, None]
    xs = torch.arange(Wd, device=prob.device)[None, None, :]
    in_border = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < Wd - border)
    nms = torch.where(in_border, nms, 0.0)
    scores, idx = torch.topk(nms.reshape(B, H * Wd), max_keypoints, dim=1)
    kpts = torch.stack([(idx % Wd).float(), (idx // Wd).float()], dim=-1)
    desc = sample_descriptors(desc_coarse, kpts)
    return {"keypoints": kpts, "scores": scores, "descriptors": desc,
            "valid": scores > score_threshold}


class SuperPointExtractor:
    """Network + NMS/top-K/descriptor sampling on one device.

    params: the JAX package's parameter tree as nested dicts of numpy arrays
    (e.g. training.checkpoints.load_params of the shipped npz); None builds
    random weights from torch seed 0. device None means cuda."""

    def __init__(self, params=None, max_keypoints: int = 1024, nms_radius: int = 4,
                 score_threshold: float = 0.0005, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_radius
        self.score_threshold = score_threshold
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.model = SuperPoint(dtype=dtype)
        if params is not None:
            self.model.load_state_dict(W.superpoint_state_dict(params))
        self.model = self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images):
        """images: [B,H,W] or [B,H,W,1] grayscale in [0,1]."""
        images = torch.as_tensor(images, device=self.device).float()
        if images.dim() == 3:
            images = images[..., None]
        prob, desc_coarse = self.model(images)
        return extract_keypoints(prob, desc_coarse, max_keypoints=self.max_keypoints,
                                 nms_radius=self.nms_radius,
                                 score_threshold=self.score_threshold)


def load_torch_weights(path: str) -> dict:
    """The public `superpoint_v1.pth` state dict (magicleap layout:
    conv1a ... convDb, weight [out, in, kh, kw] and bias) as the parameter
    tree SuperPointExtractor takes (the JAX package's layout: kernels
    [kh, kw, in, out], numpy float32)."""
    import numpy as np
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = {}
    for name in W.SUPERPOINT_LAYERS:
        leaf = {"kernel": sd[f"{name}.weight"].float().numpy().transpose(2, 3, 1, 0),
                "bias": np.asarray(sd[f"{name}.bias"].float().numpy())}
        params[name] = leaf if name in ("convPb", "convDb") else {"conv": leaf}
    return params
