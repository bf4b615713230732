"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix and its metrics, each found by name."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads``: its configuration file, its traffic
    file (``benchmark/traffic/<traffic>.json``) and the metrics it
    reports."""

    def __init__(self, bench, name, root=ROOT, bench_dir=BENCH_DIR):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(by_name)}")
        self.entry = by_name[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", f"{self.entry['traffic']}.json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]
        self.bench_dir = bench_dir

    def reference(self):
        """The plain reference module the configuration names."""
        return load_reference(self.config["reference"], self.bench_dir)

    def _has(self, metric):
        return self.name in metric.get("workloads", [self.name])

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end


def metric_reader(name, bench_dir=BENCH_DIR):
    """``read(record)`` of ``benchmark/metrics/<name>.py``: the metric's
    value from a run's record, or None where the record has nothing for
    it."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_reference(name, bench_dir=BENCH_DIR):
    """``benchmark/reference/<name>.py``, the plain reference that a
    configuration names under ``"reference"``."""
    path = os.path.join(bench_dir, "reference", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_reference_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(metrics, record, bench_dir=BENCH_DIR):
    """{name: {"value", "unit"}} of every metric whose reader finds
    something in ``record``."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], bench_dir)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
