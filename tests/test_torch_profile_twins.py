"""The profiling twins' entry points on the CPU: profile_stages_port.py,
profile_insert_port.py and profile_iters_port.py.

- main(device="cpu") at a cut size (240x320, 192 keypoints, 2 LightGlue
  layers, tables 32 / 192 / 4096, a few frames, one warm-up call and one
  timed call a line) prints every line of its JAX script under its name,
  the patterns read from that script's source (tests/profile_twins.
  script_patterns), each timed line followed by its kernel launches and
  host syncs; profile_insert_port saves its snapshot and profiles it again
  from --state.
- main() without a CUDA device exits 1.
- bench_port's helpers the twins share: output_digest, clone_state and
  profile_call.
"""
import pytest
import torch

import bench_port
import profile_insert_port
import profile_iters_port
import profile_stages_port
from profile_twins import assert_prints_lines, printed_lines, script_patterns

# tests/test_torch_bench_port.py's widths, one warm-up and one timed call a line.
CUT = dict(hw=(240, 320), n_kpts=192, layers=2, tables=(32, 4096), warmup=1, reps=1)

SCRIPTS = {"profile_stages.py": 9, "profile_insert.py": 14, "profile_iters.py": 13}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_patterns_are_read_from_the_script(script):
    """Each of the JAX script's print calls gives one pattern a line (one
    a value of the loops around it)."""
    assert len(script_patterns(script)) == SCRIPTS[script]


def test_stages_main(capsys):
    assert profile_stages_port.main(device="cpu", n_frames=16, revs=0.4 * 16 / 60,
                                    fused_reps=1, **CUT) == 0
    lines = printed_lines(capsys)
    assert_prints_lines("profile_stages.py", lines)
    assert lines[-1] == "device cpu"


def test_iters_main(capsys):
    assert profile_iters_port.main(device="cpu", n_frames=16, revs=0.33 * 16 / 50, **CUT) == 0
    lines = printed_lines(capsys)
    assert_prints_lines("profile_iters.py", lines)
    assert lines[-1] == "device cpu"


def test_insert_main_and_state(tmp_path, capsys):
    snap = str(tmp_path / "snap.npz")
    assert profile_insert_port.main(["--out", snap], device="cpu", n_warm=10, n_timed=6,
                                    **CUT) == 0
    first = printed_lines(capsys)
    assert_prints_lines("profile_insert.py", first)
    assert profile_insert_port.main(["--state", snap], device="cpu", hw=CUT["hw"],
                                    warmup=1, reps=1) == 0
    again = printed_lines(capsys)
    assert_prints_lines("profile_insert.py", again)
    state = [ln for ln in first if ln.startswith("state:")]
    assert state and state == [ln for ln in again if ln.startswith("state:")]


@pytest.mark.parametrize("twin", [profile_stages_port, profile_iters_port, profile_insert_port])
def test_main_needs_cuda_unless_asked(twin):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    assert (twin.main([]) if twin is profile_insert_port else twin.main()) == 1


def test_output_digest():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    d = bench_port.output_digest((a, torch.tensor(True), 3))
    assert d == bench_port.output_digest((a.clone(), torch.tensor(True), 3)) and len(d) == 16
    yes = torch.tensor(True)
    for other in ((a.to(torch.bfloat16), yes, 3), (a.reshape(3, 2), yes, 3),
                  (a, torch.tensor(False), 3), (a, yes, 4)):
        assert bench_port.output_digest(other) != d


def test_clone_state_shares_no_storage():
    from rover_slam_tpu_torch.map import map_state as ms
    st = ms.empty_map(K=4, N=8, L=16, D=8)
    c = bench_port.clone_state(st)
    for f in ms.FIELDS:
        a, b = getattr(st, f), getattr(c, f)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), f


def test_profile_call_counts_on_the_cpu():
    """Warm-up calls and the counted call give one digest each; the timed
    calls come on top; no launch and no sync count on the CPU."""
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3) * len(calls)
    r = bench_port.profile_call(fn, torch.device("cpu"), warmup=2, reps=3, minus_ms=1e9)
    assert len(calls) == 2 + 1 + 3 and len(r["digests"]) == 3
    assert len(set(r["digests"])) == 3 and torch.equal(r["out"], torch.full((3,), 3.0))
    assert (r["b1"], r["b2"], r["syncs"], r["b1_by_batch"]) == (0, 0, None, {})
    assert r["ms"] < 0           # minus_ms is subtracted from the time a call
    assert bench_port.counts(r) == "b1=0 b2=0 syncs=None"
