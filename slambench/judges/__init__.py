"""Checks a configuration names in its "checks" list, one module each:
slambench/judges/<name>.py with

    judge(cfg, scene, cap, trees, dev, outcome, control) -> (numbers, control readings)

numbers: {number: value}, each read from what the window kept
(cap.samples[kind], for a kind the system declares in its SAMPLE_P) against
a plain reference under slambench/reference/, held <= cfg["limits"][number]
by checks.judge; None where there is nothing to read (and fails). control
readings: {number: value} of the configuration's lower-precision control on
the same samples with control=True, {} without."""
