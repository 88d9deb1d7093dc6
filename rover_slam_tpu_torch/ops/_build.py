"""Build the port's CUDA sources (`csrc/*.cu`) with nvcc and load them.

Each source becomes its own shared library with a plain C interface, loaded
with ctypes (no PyTorch headers, so a build takes seconds). Libraries are
built at first use into `_build/` beside `csrc/`, named by a hash of the
source and of the shared headers (`csrc/*.cuh`) so an edited kernel is never
served from a stale build.
`build()` starts one nvcc per source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_attention", "nn_matcher", "pose_opt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of rover_slam_tpu_torch "
                       "are built from csrc/ at first use")


def _target(name: str) -> tuple[str, str]:
    """The source of `name` and its library path, named by a hash of the
    source and of every shared header in csrc/ (an edited header rebuilds)."""
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    h = hashlib.sha256()
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no current build, one nvcc process
    each, all started together. Returns {name: seconds} for what was built;
    the ptxas report (registers, shared memory, spills) goes to
    `_build/<name>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        p = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((name, so, tmp, p, time.perf_counter()))
    took = {}
    failed = []
    for name, so, tmp, p, t0 in procs:
        log, _ = p.communicate()
        took[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
            f.write(log)
        if p.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name)[1])
        _libs[name] = lib
    return lib


def check(status: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
