"""BENCHMARK.json and the files it names: the contract's shape, names and
units, a reader for every metric, and a cell added as new files found
without an edit to any file there."""

import json
import os
import re
import shutil

import pytest
from conftest import BENCH, ROOT

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("key,fields", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(bench, key, fields):
    for entry in bench[key]:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert fields <= set(entry) <= fields | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200
                assert "\n" not in entry[text] and "\t" not in entry[text]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")


def test_names_are_distinct_and_cells_resolve(bench):
    for key in ("configs", "workloads"):
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        assert cell.chips == 1
        assert cell.config["name"] == w["config"]
        assert NAME.match(w["traffic"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_config_files_state_their_cuts(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = spec.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and NAME.match(key)


def test_bounds_and_sources(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        for w in m["workloads"]:
            cell = spec.Cell(bench, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        read = spec.metric_reader(m["name"])
        if m["name"] in ("setup_s", "peak_mem_gib"):
            continue
        assert read({"trace": None, "phases": {}}) is None, m["name"]


def test_a_roofline_reader_is_silent_without_its_kernel():
    tr = {"device_ops": {"other": 1.0}, "calls": {"other": 3},
          "busy_s": 1.0, "window_s": 2.0, "kernels": 3}
    assert spec.metric_reader("auction_roofline")(
        {"trace": tr, "auction_bound_s": 1e-5}) is None
    assert spec.metric_reader("k4b_roofline")(
        {"trace": tr, "k4b_bound_s": 1e-3}) is None
    tr["device_ops"]["void auction_kernel(float const*)"] = 0.002
    tr["calls"]["void auction_kernel(float const*)"] = 10
    got = spec.metric_reader("auction_roofline")(
        {"trace": tr, "auction_bound_s": 1e-5})
    assert got == pytest.approx(5.0)


def test_a_cell_added_as_new_files_is_found(tmp_path, bench):
    """A later cell, with a configuration of another method and an
    end-to-end metric of its own, needs BENCHMARK.json entries and new
    files only: its configuration, its traffic, its reference and its
    metric's reader, each found by name."""
    import numpy as np

    from harness import task_eval

    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = "argmax_imagenet.zs_q150"
    new = json.loads(json.dumps(bench))
    new["configs"].append({
        "name": "argmax_imagenet", "source": "https://example.org/argmax",
        "file": "benchmark/configs/argmax_imagenet.json", "reduced": [],
        "why": "a method of another reference"})
    new["workloads"].append({
        "name": name, "config": "argmax_imagenet", "traffic": "zs_q150",
        "chips": 1, "why": "longer query sets"})
    new["end_to_end"].append({
        "name": "task_ms.argmax", "unit": "ms/task", "better": "lower",
        "bound": 0.05, "source": "host_clock", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cfg = json.loads((bench_dir / "configs" /
                      "em_dirichlet_imagenet.json").read_text())
    cfg.update(name="argmax_imagenet", reference="argmax",
               reference_options={"offset": 0})
    (bench_dir / "configs" / "argmax_imagenet.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "zs.json").read_text())
    traffic["n_query"] = 150
    (bench_dir / "traffic" / "zs_q150.json").write_text(json.dumps(traffic))
    (bench_dir / "reference" / "argmax.py").write_text(
        "import numpy as np\n"
        "CONTROL = None\n"
        "def solve(x, protocol, options, support=None,\n"
        "          support_labels=None, quant=None):\n"
        "    preds = x.argmax(-1).numpy() + options['offset']\n"
        "    return preds, np.zeros(len(preds), np.int64)\n")
    (bench_dir / "metrics" / "task_ms.argmax.py").write_text(
        "from harness.readers import per_task_ms as read  # noqa: F401\n")

    cell = spec.Cell(spec.load_benchmark(str(tmp_path)), name,
                     root=str(tmp_path), bench_dir=str(bench_dir))
    assert cell.traffic["n_query"] == 150
    assert {m["name"] for m in cell.end_to_end} == {
        "task_ms.argmax", "peak_mem_gib", "setup_s"}
    assert spec.read_metrics(cell.metrics(False), {
        "tasks": 10, "window_s": 1.0, "peak_bytes": 2 ** 30, "setup_s": 3.0},
        bench_dir=str(bench_dir)) == {
        "task_ms.argmax": {"value": 100.0, "unit": "ms/task"},
        "peak_mem_gib": {"value": 1.0, "unit": "GiB"},
        "setup_s": {"value": 3.0, "unit": "s"}}
    # the check solves the recorded tasks with the cell's own reference
    rows = np.random.default_rng(0).random((6, 5)).astype(np.float32)
    preds, _ = task_eval.reference_answers(
        cell, [(None, np.array([0, 2, 4])), (None, np.array([1, 3, 5]))],
        (rows, np.zeros(6, np.int64)), None, device="cpu")
    assert (preds == rows.argmax(1)[[[0, 2, 4], [1, 3, 5]]]).all()
