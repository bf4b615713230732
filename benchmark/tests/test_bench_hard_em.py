"""The Hard EM-Dirichlet cell (``hard_em_dirichlet_imagenet.zs``): declared
on one chip under the zero-shot metrics, its configuration the soft
cell's protocol with the hard method and its reference options, and the
readers of the compact-step counters (``fast_tier_share.zs``,
``populated_per_step.zs``): each gives the hand value on a made-up record
and nothing without its counters. A CPU run of the cell, cut to a size
at which cluster compaction and its fast tier engage, is correct and
carries the counters into its record."""

import os

import pytest
import torch

from harness import main, spec, task_eval

torch.set_num_threads(4)
SEED = 2 ** 31 + 27027
CELL = "hard_em_dirichlet_imagenet.zs"
SOFT = "em_dirichlet_imagenet.zs"
APPENDED = ("sampling_ms_per_batch.zs", "host_syncs_per_batch.zs",
            "kernels_per_batch.zs", "auction_roofline", "mfu.zs",
            "idle_share.zs")
COUNTERS = ("em.compact_steps", "em.fast_steps", "em.populated")


def tiny_hard_cell():
    """The cell at 80 classes and 20 queries (compaction engages above 2 x
    (20 + 16) classes; its 36-row width leaves a 32-row fast tier): 2
    evaluations of 2 batches of 2 tasks, every task checked."""
    cell = spec.Cell(spec.load_benchmark(), CELL)
    cell.config.update(n_class=80, test_per_class=30, train_per_class=6,
                       features=dict(cell.config["features"], embed_dim=64))
    cell.traffic.update(evaluations=2, number_tasks=4, batch_size=2,
                        n_query=20, check_tasks=8)
    return cell


def test_the_cell_is_declared_on_one_chip_under_the_zero_shot_metrics():
    bench = spec.load_benchmark()
    cell = spec.Cell(bench, CELL)
    assert cell.chips == 1 and cell.entry["traffic"] == "zs"
    assert [m["name"] for m in cell.metrics(False)] == [
        "task_ms.zs", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in cell.metrics(True)] == list(APPENDED)
    soft = spec.Cell(bench, SOFT)
    assert [m["name"] for m in soft.metrics(True)][:len(APPENDED)] == list(
        APPENDED)
    for m in cell.metrics(True):
        assert m["moves"] == "task_ms.zs"
        assert m["workloads"] == [SOFT, CELL]


def test_the_configuration_is_the_soft_protocol_under_hard_em():
    hard = spec.Cell(spec.load_benchmark(), CELL).config
    soft = spec.Cell(spec.load_benchmark(), SOFT).config
    assert hard["method"] == "hard_em_dirichlet" and hard["reduced"] == []
    for key in ("runner", "reference", "dataset", "n_class", "T",
                "test_per_class", "train_per_class", "data_seed",
                "features", "precision"):
        assert hard[key] == soft[key], key
    # the method's own iteration count (config/methods_config): the
    # reference runs what the program runs
    from transductive_clip_tpu_torch.core.config import load_full_config

    args = load_full_config(opts=["method", "hard_em_dirichlet", "shots",
                                  "0", "dataset", "imagenet"],
                            config_root=os.path.join(spec.ROOT, "config"))
    assert hard["reference_options"] == {
        "hard": True, "iterations": int(args.iter), "tol": 1e-06,
        "newton_steps": 30}
    assert set(hard["limits"]) == set(soft["limits"])


def _record():
    return {"window_s": 20.0, "batches": 10,
            "phases": {"em.iterations": 110.0, "em.compact_steps": 110.0,
                       "em.fast_steps": 88.0, "em.populated": 1650.0}}


@pytest.mark.parametrize("name,want,needs", [
    ("fast_tier_share.zs", 80.0, ("em.compact_steps", "em.fast_steps")),
    ("populated_per_step.zs", 15.0, ("em.compact_steps", "em.populated")),
])
def test_reader_hand_value_and_none_without_its_counters(name, want, needs):
    read = spec.metric_reader(name)
    assert read(_record()) == pytest.approx(want)
    for missing in needs:
        rec = _record()
        del rec["phases"][missing]
        assert read(rec) is None
    # a window with no compact step (compaction off)
    rec = _record()
    rec["phases"]["em.compact_steps"] = 0.0
    assert read(rec) is None
    assert read({"window_s": 20.0, "batches": 10}) is None
    # a program from before the counters: the soft cell's counters alone
    assert read({"batches": 10, "phases": {"em.iterations": 220.0,
                                           "newton.steps": 6341.0}}) is None


def test_a_cpu_run_of_the_cell_reports_the_counters():
    cell = tiny_hard_cell()
    record = task_eval.run(cell, SEED, 0.0, False, device="cpu")
    assert record["correct"], record["checks"]
    phases = record["phases"]
    assert set(COUNTERS) <= set(phases)
    fast = spec.metric_reader("fast_tier_share.zs")(record)
    populated = spec.metric_reader("populated_per_step.zs")(record)
    # every hard step after a solve's first fits the fast tier; the
    # first, under compact_first, reads the compact width
    assert 0 < fast < 100
    assert 0 < populated <= int(cell.traffic["n_query"])
    assert record["ref_iterations"] and max(record["ref_iterations"]) == 10
    # the appended metrics read the same record, as on the soft cell
    record.update(trace={"busy_s": 0.5, "window_s": 1.0, "kernels": 40,
                         "device_ops": {}, "calls": {}, "idle_gaps": []},
                  trace_batches=2, untraced_s=0.8)
    line = main.result_line(cell, record, True, "cpu")
    assert {"sampling_ms_per_batch.zs", "host_syncs_per_batch.zs",
            "kernels_per_batch.zs", "mfu.zs",
            "idle_share.zs"} <= set(line["metrics"])
