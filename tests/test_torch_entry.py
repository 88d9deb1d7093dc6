"""The port's entry points (rover_slam_tpu_torch/entry.py) against the
repo's __graft_entry__.py: JAX entry()'s Flax parameters carried into the
port's modules with models/weights.py's converters, and one seeded frame
pair of the photo world at 240x320 through both front-end steps (bf16
SuperPoint, 256 keypoints, 3-layer LightGlue with random weights).

Shares: bf16 convolutions round differently in XLA and in torch, which
moves a score across the top-K cut now and then, and LightGlue with random
weights finds few, weak mutual matches. Measured: 99.6 % and 100 % of the
JAX keypoints found by the port, 12 of the JAX step's 14 matches (the
port's 12 all among them). Held: KPT_SHARE of each frame's keypoints,
MATCH_SHARE of the larger match set in common."""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from rover_slam_tpu_torch import entry
from rover_slam_tpu_torch.models import weights as W
from rover_slam_tpu_torch.models.lightglue import LightGlue
from rover_slam_tpu_torch.models.superpoint import SuperPoint
from rover_slam_tpu_torch.utils import synthetic

KPT_SHARE = 0.98
MATCH_SHARE = 0.75


def _pair_images():
    world = synthetic.make_photo_world(n_sprites=400, patch=17, seed=0, image_hw=entry.ENTRY_HW,
                                       layout="ring", ring_orbit_radius=5.0)
    R, t, _ = synthetic.orbit_trajectory(n_frames=40, orbit_radius=5.0, revs=0.3, dt=1 / 30)
    return np.stack([synthetic.render_photo_frame(world, R[i], t[i]).astype(np.float32) / 255.0
                     for i in (0, 3)])[..., None]


def _match_set(m, k):
    return {(tuple(k[0, i].astype(int)), tuple(k[1, j].astype(int)))
            for i, j in enumerate(m[0]) if j >= 0}


@pytest.fixture(scope="module")
def steps():
    fn_j, (sp_p, lg_p, _) = __graft_entry__.entry()
    sp_p, lg_p = jax.tree_util.tree_map(np.asarray, (sp_p, lg_p))
    imgs = _pair_images()
    out_j = [np.asarray(a) for a in jax.jit(fn_j)(sp_p, lg_p, imgs)]
    sp = SuperPoint(dtype=torch.bfloat16)
    sp.load_state_dict(W.superpoint_state_dict(sp_p))
    lg = LightGlue(num_layers=entry.ENTRY_LAYERS, dtype=torch.bfloat16)
    lg.load_state_dict(W.lightglue_state_dict(lg_p))
    fn_t, args = entry.entry(device="cpu")
    out_t = [a.numpy() for a in fn_t(sp.eval(), lg.eval(), torch.from_numpy(imgs))]
    return out_j, out_t, args


def test_keypoints_agree(steps):
    (_, _, kj), (_, _, kt), _ = steps
    assert kt.shape == kj.shape == (2, entry.ENTRY_KPTS, 2)
    for f in range(2):
        a, b = set(map(tuple, kj[f].astype(int).tolist())), set(map(tuple, kt[f].astype(int).tolist()))
        assert len(a & b) >= KPT_SHARE * len(a), (f, len(a & b))


def test_matches_agree(steps):
    (mj, _, kj), (mt, st, kt), _ = steps
    A, B = _match_set(mj, kj), _match_set(mt, kt)
    assert len(A) > 0 and len(A & B) >= MATCH_SHARE * max(len(A), len(B)), (len(A), len(B))
    assert mt.dtype == np.int32 and np.all(st[mt < 0] == 0)


def test_example_args(steps):
    """entry()'s example arguments: bf16 networks at the JAX widths on the
    device asked for, Flax-style init (zero biases), a zero frame pair."""
    _, _, (sp, lg, images) = steps
    assert images.shape == (2,) + entry.ENTRY_HW + (1,) and images.device.type == "cpu"
    assert sp.dtype == lg.dtype == torch.bfloat16 and len(lg.layers) == entry.ENTRY_LAYERS
    assert float(sp.conv1a.bias.abs().max()) == 0.0


def test_dryrun_multichip():
    res = entry.dryrun_multichip(8, device="cpu")
    R, t, X, costs = res["edges"]
    assert costs.shape == (2,) and float(costs[-1]) <= float(costs[0])
    assert res["landmarks"][2].shape == (32, 3)     # 8 blocks of 4
    assert torch.isfinite(res["gba_t_cw"]).all()
