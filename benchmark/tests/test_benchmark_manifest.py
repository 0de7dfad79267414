"""BENCHMARK.json and the files it names: the contract's shapes, and
every cell, configuration, traffic mix, limit and metric found by name."""

import json
import math
import re

import pytest

from benchmark.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DOC = spec.manifest()


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in DOC[key]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in DOC["configs"] + DOC["workloads"] + DOC["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


def test_configs_are_used_and_hold_what_runs():
    used = {w["config"] for w in DOC["workloads"]}
    for c in DOC["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        doc = json.load(open(spec.ROOT / c["file"]))
        assert doc["reduced"] == c["reduced"] == []
        assert doc["tf32"] == {"matmul": False, "cudnn": False}


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.Cell(cell, DOC)
    assert c.chips == 1
    assert hasattr(c.driver(), "window") and hasattr(c.driver(), "compare")
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    e2e_set = set(e2e)
    for m in c.per_layer:
        assert m["moves"] in e2e_set
        assert callable(c.reader(m["name"]).read)
    for k, v in c.limits.items():
        assert NAME.match(k) and math.isfinite(v) and v > 0


def test_every_per_layer_metric_has_a_reader_and_a_layer():
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert spec.Cell.reader(m["name"]).read
        if m["name"].endswith(("_roofline.train", "_roofline.eval",
                               "_roofline.serve")) or "mfu" in m["name"]:
            assert m["unit"] == "%"
