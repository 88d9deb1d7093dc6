"""The lower-precision control of a cell's `correct`, run on the chip.

    python3 slambench/controls.py --workload euroc_mono.patrol --seeds 11,12,13 --seconds 15

For each seed: one run of the cell with a short window, then, on the same
samples the window kept, the program's numbers and the control's: the
reference put in the program's place in the configuration's control
precision (fp8 for the bf16 networks and the B2 reduce;
reference/precision.py), and the readings each judge the configuration
names (slambench/judges/) reports for its own control. Prints one JSON line
per seed: the program's readings (lower) and the control's (upper). The
benchmark's own runs do not run this; PERF.md records the readings the
limits were set from.
"""
import argparse
import contextlib
import json
import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from slambench import harness  # noqa: E402


def main(argv=None, device=None, root=ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)
    harness.set_cache_env(root)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            code, res = harness.run(args.workload, seed, args.seconds, False, t,
                                    device=device, root=root, control=True)
        if code != 0:
            return code
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": res["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
