"""BENCHMARK.json, and the files it names, found by name."""

import json
import os
import re

import pytest

import harness

SPEC = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    w = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert cell.traffic == harness.load_json(
        os.path.join(harness.BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "runners",
                                       f"{cell.traffic['runner']}.py"))
    assert cell.config["reduced"] == next(
        c["reduced"] for c in SPEC["configs"] if c["name"] == w["config"])
    reported = {m["name"] for m, per_layer in cell.metrics if not per_layer}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(per_layer for _, per_layer in cell.metrics)


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no_such.cell")


def test_a_later_cell_is_new_files_only(tmp_path):
    """A cell, traffic mix and metric added as files and list entries: the
    harness finds them without a change to its code."""
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "isa_k8m3.bytes_2x4m", "config": "isa_k8m3",
                              "traffic": "bytes_encode", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "setup_s", "unit": "s", "better": "lower",
                              "source": "host_clock", "layer": "x", "moves": "setup_s",
                              "workloads": ["isa_k8m3.bytes_2x4m"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    os.makedirs(tmp_path / "benchmark" / "configs")
    (tmp_path / "benchmark" / "configs" / "isa_k8m3.json").write_text(
        json.dumps(harness.load_cell(WORKLOADS[0]).config))
    cell = harness.load_cell("isa_k8m3.bytes_2x4m", root=str(tmp_path))
    assert cell.traffic["api"] == "bytes"
    assert [m["name"] for m, per_layer in cell.metrics if per_layer][-1] == "setup_s"
    assert all("isa_k8m3.bytes_2x4m" not in m.get("workloads", [])
               for m, _ in harness.load_cell(WORKLOADS[0]).metrics)
