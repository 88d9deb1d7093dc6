"""fps_unprofiled by hand, and the manifest's per-layer metrics each naming
an end-to-end metric of the manifest that the cells they list report."""
import json
import os

import pytest

from slambench.metrics import fps_unprofiled

HERE = os.path.dirname(os.path.abspath(__file__))
MANIFEST = json.load(open(os.path.join(HERE, "..", "..", "BENCHMARK.json")))


def rows(ms_each, profiled_tail=0):
    out, t = [], 0.0
    for k, ms in enumerate(ms_each):
        t += ms / 1e3 + 0.001       # a millisecond of the loop's own between frames
        out.append({"i": k, "ms": ms, "t_s": t, "profiled": k >= len(ms_each) - profiled_tail})
    return out


def test_fps_unprofiled_by_hand():
    # 20 unprofiled frames of 40 ms, one 400-ms insert and one 4-s fire among them
    ms = [40.0] * 18 + [400.0, 4000.0]
    rec = {"frames": rows(ms + [900.0] * 3, profiled_tail=3)}
    want = 20 / (sum(ms) / 1e3 + 20 * 0.001)     # over all the time up to the last of them
    assert fps_unprofiled.read(rec) == pytest.approx(want)


def test_fps_unprofiled_with_too_few_frames():
    assert fps_unprofiled.read({"frames": rows([40.0] * 9 + [900.0], profiled_tail=1)}) is None


def test_every_moves_names_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m.get("workloads") for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads") or cells:
            assert e2e[m["moves"]] is None or cell in e2e[m["moves"]], (m["name"], cell)
