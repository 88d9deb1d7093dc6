"""Slot recycling in the port against the JAX package, pipeline mode: the
scene of tests/test_torch_system_compaction.py with pipeline=True, where a
compaction waits for a flush boundary and then renumbers the landmark ids
that in-flight frames hold. 80 frames: the pipelined tracker inserts fewer
keyframes, and the table must still run out."""
from torch_parity import check_compaction_scene, run_compaction_scene


def test_tables_recycle_like_the_reference_pipelined():
    check_compaction_scene(run_compaction_scene(pipeline=True, n_frames=80))
