"""The readers of the port's own spans and counters (the evaluator's
PhaseTimer, summed into the record's ``phases``): each gives the hand value
on a made-up record and nothing where its name is missing, and a CPU run of
the zero-shot cell reports all five on its traced line."""

import pytest
import torch

from harness import main, spec, task_eval

torch.set_num_threads(4)
SEED = 2 ** 31 + 54321

READERS = ("em_iters_per_batch.zs", "newton_steps_per_batch.zs",
           "newton_rows_per_step.zs", "newton_ms_per_batch.zs",
           "host_issue_ms_per_batch.zs")


def _record():
    return {"window_s": 40.0, "batches": 10,
            "phases": {"sampling": 0.05, "method": 5.0, "dispatch": 30.0,
                       "em.iterations": 210.0, "newton.steps": 6000.0,
                       "newton.row_steps": 660000.0, "newton": 28.0,
                       "host_wait": 14.0}}


@pytest.mark.parametrize("name,want,needs", [
    ("em_iters_per_batch.zs", 21.0, ("em.iterations",)),
    ("newton_steps_per_batch.zs", 600.0, ("newton.steps",)),
    ("newton_rows_per_step.zs", 110.0, ("newton.row_steps", "newton.steps")),
    ("newton_ms_per_batch.zs", 2800.0, ("newton",)),
    ("host_issue_ms_per_batch.zs", 2600.0, ("host_wait",)),
])
def test_reader_hand_value_and_none_without_its_name(name, want, needs):
    read = spec.metric_reader(name)
    assert read(_record()) == pytest.approx(want)
    for missing in needs:
        rec = _record()
        del rec["phases"][missing]
        assert read(rec) is None
    assert read({"window_s": 40.0, "batches": 10}) is None
    if name.endswith("_per_batch.zs"):
        assert read(dict(_record(), batches=0)) is None


def test_the_entries_read_the_zero_shot_cell_only(zs_cell):
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == ["em_dirichlet_imagenet.zs"]
        assert m["moves"] == "task_ms.zs" and m["layer"] == "Method"
    assert set(READERS) <= {m["name"] for m in zs_cell.metrics(True)}


def test_a_cpu_run_of_the_zero_shot_cell_reports_all_five(zs_cell):
    record = task_eval.run(zs_cell, SEED, 0.0, False, device="cpu")
    assert record["correct"]
    # the device trace is the card's: stand in for it, as a traced run on
    # the card fills it
    record.update(trace={"busy_s": 0.5, "window_s": 1.0, "kernels": 40,
                         "device_ops": {}, "calls": {}, "idle_gaps": []},
                  trace_batches=2, untraced_s=0.8)
    line = main.result_line(zs_cell, record, True, "cpu")
    got = {name: line["metrics"][name]["value"] for name in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    n_class = int(zs_cell.config["n_class"])
    # every solve of the tiny cell is full width (no compaction at 40
    # classes and 10 queries); the solves are part of the batches' time
    assert got["newton_rows_per_step.zs"] == n_class
    per_batch_ms = 1e3 * record["window_s"] / record["batches"]
    assert got["newton_ms_per_batch.zs"] < per_batch_ms
    assert got["host_issue_ms_per_batch.zs"] < per_batch_ms
    assert got["em_iters_per_batch.zs"] >= 1
    assert got["newton_steps_per_batch.zs"] >= got["em_iters_per_batch.zs"]
