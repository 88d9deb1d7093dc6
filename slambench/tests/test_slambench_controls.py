"""The lower-precision control of `correct` comes out as not correct: the
reference put in the program's place in the configuration's control
precision (fp8 for the bf16 networks and B2; a judge's own control for the
numbers it reports) fails the cell's limits on the samples a window kept.

On the CPU at the tiny size (tiny.py); on the card at each cell's own size,
three seeds (marked cuda: skips without a card)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from slambench.tests import tiny

CONTROL = """
import json, sys
sys.path.insert(0, {root!r})
from slambench import controls
sys.exit(controls.main({argv!r}, device={device!r}, root={root!r}))
"""


def control_lines(root, argv, device):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", CONTROL.format(root=root, argv=argv, device=device)],
                       cwd=root, env=env, capture_output=True, text=True, timeout=3000)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]


def fails_a_limit(line, limits) -> bool:
    return any(line["control"][k] is not None and line["control"][k] > lim
               for k, lim in limits.items() if k in line["control"])


def test_control_fails_at_tiny_size(tmp_path):
    root = tiny.checkout(str(tmp_path))
    lines = control_lines(root, ["--workload", tiny.TINY, "--seeds", "21", "--seconds", "4"],
                          "cpu")
    (line,) = lines   # the toy cell's own tracking is not this test's subject
    assert fails_a_limit(line, tiny.TINY_LIMITS), line
    for k in ("sp_logp_gap", "sp_desc_gap"):
        assert line["control"][k] >= 3 * line["program"][k], (k, line)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["euroc_mono.patrol"])
def test_control_fails_at_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    root = tiny.REPO
    manifest = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cell = {w["name"]: w for w in manifest["workloads"]}[workload]
    cfg_file = {c["name"]: c["file"] for c in manifest["configs"]}[cell["config"]]
    limits = json.load(open(os.path.join(root, cfg_file)))["limits"]
    lines = control_lines(root, ["--workload", workload, "--seeds", "31,32,33",
                                 "--seconds", "10"], None)
    assert len(lines) == 3
    for line in lines:
        assert line["correct"] is True, line
        assert fails_a_limit(line, limits), line
