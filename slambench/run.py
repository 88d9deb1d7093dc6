"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 slambench/run.py --workload euroc_mono.patrol --seed 7 --seconds 50 --trace 0

Prints progress and each compared number beside its limit on standard
error, and one JSON line on standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and checks last. Exits 2
without enough CUDA devices, and with another non-zero code and no result
line when the run fails or a module of jax, jaxlib, flax or rover_slam_tpu
(top-level names compared whole) was loaded.
"""
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_env(ROOT)
    sys.exit(harness.main(t_process=T_PROCESS))
