"""CPU tests of the benchmark (slambench/tests/test_slambench_*.py); the
cases marked cuda decide inside the test whether a card is there."""
