"""profile_iters_port.py's sweep, the twin of profile_iters.py, against the
JAX package on the CPU: its two shorter schedules, (1,3,2,3) and (1,3,1,4)
(the first two: tests/test_torch_profile_iters.py, whose docstring gives
the snapshot and the comparison).
"""
import pytest

from profile_iters_port import SCHEDULES
from profile_twins import check_schedule, iters_pair


@pytest.fixture(scope="module")
def pair():
    return iters_pair(SCHEDULES[2:])


@pytest.mark.parametrize("sched", SCHEDULES[2:])
def test_schedule_flags_match_jax(pair, sched):
    check_schedule(pair, sched)
