"""Scenes of the benchmark, found by name from BENCHMARK.json."""
