"""The harness end to end on the CPU at a tiny size (tiny.py), and its
refusals: no card, a checkout without the program, a module of JAX or the
JAX package in the process."""
import ast
import os
import subprocess
import sys

from slambench import harness
from slambench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_tiny_cpu_run(tmp_path):
    root = tiny.checkout(str(tmp_path))
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv())
    assert code == 0, err[-3000:]
    assert KEYS <= set(last) and list(last)[-1] == "checks"
    assert last["correct"] is True, err[-3000:]
    assert set(last["metrics"]) == {"frame_ms_median", "setup_s"}
    assert last["attempted"] > 0 and last["failed"] == 0
    assert "FORBIDDEN []" in err
    # each compared number beside its limit, last on stderr
    tail = [ln for ln in err.splitlines() if ln.startswith("check ")]
    assert [ln.split()[1] for ln in tail] == list(last["checks"])


def test_tiny_cpu_traced_run(tmp_path):
    root = tiny.checkout(str(tmp_path))
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(trace=1))
    assert code == 0, err[-3000:]
    assert last["correct"] is True
    for k in ("busy_s", "window_s"):
        assert k in last["device"]
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU run traces no device: only host-side readers report
    assert {"track_ms", "frame_mfu_pct"} <= set(last["metrics"])


def test_refuses_without_a_card(tmp_path):
    """The command itself (no device override) exits non-zero and prints no
    result where torch finds no CUDA device."""
    root = tiny.checkout(str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "slambench/run.py", *tiny.tiny_argv()], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    root = tiny.checkout(str(tmp_path), link_program=False)
    assert sorted(os.listdir(root)) == ["BENCHMARK.json", "slambench"]
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv())
    assert code != 0 and last is None


def test_refuses_when_jax_is_loaded(tmp_path):
    """A module named jax (a stand-in) in sys.modules once the window has
    closed: non-zero exit, no result, and stderr names it."""
    root = tiny.checkout(str(tmp_path))
    prelude = "import types; sys.modules['jax'] = types.ModuleType('jax')"
    code, last, err = tiny.run_cpu(root, tiny.tiny_argv(), prelude=prelude)
    assert code != 0 and last is None and "'jax'" in err


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("rover_slam_tpu_torch_lookalike", sys)
    try:
        assert "rover_slam_tpu_torch_lookalike" not in harness.forbidden_modules()
        assert not any(m.split(".")[0] == "rover_slam_tpu_torch"
                       for m in harness.forbidden_modules())
    finally:
        del sys.modules["rover_slam_tpu_torch_lookalike"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_neither_jax_nor_either_package():
    ref = os.path.join(os.path.dirname(harness.__file__), "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            bad = {"jax", "jaxlib", "flax", "rover_slam_tpu", "rover_slam_tpu_torch"}
            assert not bad & set(_imports(os.path.join(ref, name))), name


def test_harness_never_imports_jax_or_the_jax_package():
    base = os.path.dirname(harness.__file__)
    for d, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                found = set(_imports(os.path.join(d, name)))
                assert not {"jax", "jaxlib", "flax", "rover_slam_tpu"} & found, name
