"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its ``configs`` entry names; its
traffic is ``benchmark/traffic/<traffic>.json``; each per-layer metric is
``benchmark/metrics/<name>.py``, a module with ``WRAPS`` (the port's
``module:function`` whose calls it times, or ``None``) and
``read(record)``.  Adding a cell, a configuration or a metric adds files
and entries and edits none.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_metric(name: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(workload: str, root: str = ROOT) -> dict:
    """Everything one cell runs with: its entry, configuration, traffic,
    end-to-end metrics and per-layer metric modules."""
    bench = load_benchmark(root)
    (entry,) = [w for w in bench["workloads"] if w["name"] == workload]
    (config,) = [c for c in bench["configs"] if c["name"] == entry["config"]]
    traffic = os.path.join(root, "benchmark", "traffic",
                           f"{entry['traffic']}.json")
    return {
        "entry": entry,
        "config_path": os.path.join(root, config["file"]),
        "traffic_path": traffic,
        "end_to_end": [m for m in bench["end_to_end"]
                       if applies(m, workload)],
        "per_layer": [(m, load_metric(m["name"], root))
                      for m in bench["per_layer"] if applies(m, workload)],
    }
