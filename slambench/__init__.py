"""The benchmark of rover_slam_tpu_torch: BENCHMARK.json's command runs
slambench/run.py; see harness.py."""
