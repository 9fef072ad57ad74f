"""BENCHMARK.json against the benchmark's contract: it parses, its names and
files exist, every per-layer metric's end-to-end metric is reported in each
of its cells, and each metric has its reader."""

import json
import os
import re

import pytest

from gpubench import bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["gpubench"] and SPEC["command"][1] == "gpubench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]] + CELLS
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = bench.Cell(cell, root=REPO)
    assert c.chips in (1, 4)
    assert os.path.isfile(os.path.join(REPO, c.config_entry["file"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(bench.reader(m["name"], REPO))
    for key in c.config_entry["reduced"]:
        assert not key.endswith(("_dim", "_rank")) and NAME.match(key)
        assert key in c.config["overrides"], key
    # an override is a cut (`reduced`) or an execution setting stated under `assumed`
    assert set(c.config["overrides"]) <= set(c.config_entry["reduced"]) | set(c.config["assumed"])
    assert c.config["reduced"] == c.config_entry["reduced"]


def test_every_metric_cell_exists():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in CELLS, (m["name"], cell)
