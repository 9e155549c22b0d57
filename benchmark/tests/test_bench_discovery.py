"""BENCHMARK.json against the contract's shape, and the harness finding
every configuration, traffic mix and metric reader by name, so a later cell
or metric is data and files, not an edit."""

import json
import os
import re

import pytest

from benchmark.run import BENCH, ROOT, cell_of, load_json, reader

SPEC = load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs():
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert c["file"] not in files
        files.add(c["file"])
        conf = load_json(ROOT, c["file"])
        assert conf["name"] == c["name"]
        assert all(k in conf["reduced"] for k in c["reduced"])
        assert sum(n for _, n in conf["genome"]["contigs"]) == \
            conf["genome"]["total_bp"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(reader(m["name"]))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_each_cell_of_a_metric_reports_what_it_moves():
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", CELLS):
            e2e = [x["name"] for x in cell_of(SPEC, cell)["end_to_end"]]
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = cell_of(SPEC, cell)
    names = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]


def test_kernel_layers_name_the_layers_of_the_metrics():
    table = load_json(BENCH, "kernel_layers.json")
    src = open(os.path.join(ROOT, "longreadmapper_tpu_torch", "csrc",
                            "vote.cu")).read()
    assert "seed_tables_kernel" in src
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert set(table.values()) <= layers


def test_a_cell_added_as_data():
    """A new cell on an existing mix and configuration needs an entry and
    nothing else."""
    spec = json.loads(json.dumps(SPEC))
    w = dict(spec["workloads"][0], name="yeast.extra")
    spec["workloads"].append(w)
    c = cell_of(spec, "yeast.extra")
    assert c["traffic"] == cell_of(SPEC, spec["workloads"][0]["name"])[
        "traffic"]
    assert [m["name"] for m in c["end_to_end"]] == [
        m["name"] for m in spec["end_to_end"] if "workloads" not in m]
