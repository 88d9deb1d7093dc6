"""Plain PyTorch / NumPy references that decide a run's `correct`.

Frozen, straightforward copies of the arithmetic the port runs on its timed
path: the SuperPoint and LightGlue forwards (float32, TF32 off), the mutual
nearest-neighbour reduce and the Horn / ATE alignment. Nothing here imports
jax, the JAX package or the port; the weights come from the shipped npz
files, read as plain arrays.

Every forward takes `precision`: "f32" is the reference; "fp8" rounds the
inputs of every product to that format (precision.py), which is how the
lower-precision control of slambench/controls.py runs.
"""
