"""profile_iters_port.py's sweep, the twin of profile_iters.py, against the
JAX package on the CPU: its first two schedules, (2,5,2,6) and (1,4,2,4)
(the other two: tests/test_torch_profile_iters_short.py; one JAX compile a
schedule keeps each file short).

On one small snapshot (tests/profile_twins.snapshot: the ring-orbit map
the port builds, without the landmarks its newest keyframe created, carried
to JAX with to_jax_state; that keyframe tracked again as the previous
frame), the fused program's ok / ins flags, n_inl and n_kf of each schedule
equal, exactly, those of the JAX _track_and_map_kernel called as
profile_iters.py calls it (tests/profile_twins.check_schedule).
"""
import pytest

from profile_iters_port import SCHEDULES
from profile_twins import check_schedule, iters_pair


@pytest.fixture(scope="module")
def pair():
    return iters_pair(SCHEDULES[:2])


@pytest.mark.parametrize("sched", SCHEDULES[:2])
def test_schedule_flags_match_jax(pair, sched):
    check_schedule(pair, sched)
