"""``BENCHMARK.json`` keeps to the benchmark's schema, and every
file it names is found by name."""

import json
import os
import re

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_keep_to_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = spec.cell(workload)
    with open(cell["config_path"]) as f:
        config = json.load(f)
    with open(cell["traffic_path"]) as f:
        json.load(f)
    assert config["name"] == cell["entry"]["config"]
    assert set(config["limits"]) >= {"hits_differing", "pvalue_rel_err"}
    assert os.path.isfile(os.path.join(spec.ROOT, config["motif_file"]))
    for metric, module in cell["per_layer"]:
        assert callable(module.read), metric["name"]
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moved_metric_reported_in_every_cell_of_the_metric(metric):
    (m,) = [x for x in BENCH["per_layer"] if x["name"] == metric]
    moved = [x for x in BENCH["end_to_end"] if x["name"] == m["moves"]]
    assert len(moved) == 1
    cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
    assert all(spec.applies(moved[0], c) for c in cells)
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    if metric.endswith("_roofline"):
        assert m["unit"] == "%"


def test_one_layer_name_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])
    with open(os.path.join(spec.ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in layers:
        assert layer in perf, layer
