"""Write the place-recognition codebooks the PyTorch port ships
(rover_slam_tpu_torch/assets/bow_codebooks.npz).

The JAX package draws its bag-of-words codebook at run time,
`keyframe_database.make_vocab(D, n_words, seed)`: jax.random.normal from
PRNGKey(seed), each column normalized. The port cannot call JAX, so it loads
the same arrays from the npz. This script regenerates them with the JAX
package on the CPU:

    JAX_PLATFORMS=cpu python3 make_bow_codebooks.py [--add D:SEED ...]

By default it writes D=64 (the synthetic scenes) and D=256 (bench.py's
SuperPoint descriptors), 2048 words, seed 3 (LoopCloser's). tests/
test_torch_loop_components.py checks the shipped file against this
generator bit for bit.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

N_WORDS = 2048
DEFAULT = ((64, 3), (256, 3))
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rover_slam_tpu_torch",
                    "assets", "bow_codebooks.npz")


def key(desc_dim: int, n_words: int, seed: int) -> str:
    return f"d{desc_dim}_w{n_words}_s{seed}"


def generate(pairs=DEFAULT, n_words: int = N_WORDS) -> dict:
    from rover_slam_tpu.map import keyframe_database as kdb
    return {key(d, n_words, s): np.asarray(kdb.make_vocab(d, n_words, s).codebook, np.float32)
            for d, s in pairs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--add", nargs="*", default=[], metavar="D:SEED",
                    help="extra (descriptor dim, seed) codebooks beside the defaults")
    args = ap.parse_args()
    pairs = list(DEFAULT) + [tuple(int(x) for x in a.split(":")) for a in args.add]
    arrays = generate(pairs)
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez(PATH, **arrays)
    print(PATH, {k: v.shape for k, v in arrays.items()})


if __name__ == "__main__":
    main()
