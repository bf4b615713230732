"""The device's idle time by program span (harness/idle.py): each idle
stretch of the traced window, its head and tail too, goes to the innermost
of the port's spans open over it, the parts sum to the window less the busy
time, and the readers scale them to the untraced idle time, reading
nothing where a record has no idle time by span. On the CPU, under a
profiler standing in for the card's, the tiny cells carry the port's spans
into the reduction and their readings sum to their idle time."""

import time

import pytest
import torch

from harness import extraction, idle, spec, task_eval, trace

torch.set_num_threads(4)
SEED = 2 ** 31 + 98765

TASK_READERS = ("newton_idle_ms_per_batch.zs", "em_step_idle_ms_per_batch.zs",
                "wait_idle_ms_per_batch.zs", "upload_idle_ms_per_batch.zs",
                "pools_idle_ms_per_batch.zs", "other_idle_ms_per_batch.zs")
EXTRACT_READERS = ("softmax_idle_ms_per_pass.extract",
                   "issue_idle_ms_per_pass.extract",
                   "other_idle_ms_per_pass.extract")


def _dev(s, t):
    return ("kernel", True, s, t)


def _host(s, t):
    return ("aten::op", False, s, t)


def _approx(got, want):
    assert set(got) == set(want), got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), (k, got)


def test_innermost_of_three_nested_ranges():
    ranges = [("method", 0, 100), ("em.step", 10, 90), ("newton", 20, 60)]
    events = [_host(0, 100), _dev(0, 10), _dev(30, 40), _dev(90, 100)]
    # idle [10, 30] -> em.step 10, newton 10; [40, 90] -> newton 20,
    # em.step 30
    _approx(idle.idle_by_span(ranges, events),
            {"method": 0.0, "em.step": 40e-6, "newton": 30e-6, "": 0.0})


def test_the_idle_head_and_tail_count():
    ranges = [("upload", 0, 30), ("extract.softmax", 70, 120)]
    events = [_host(0, 120), _dev(20, 80)]
    _approx(idle.idle_by_span(ranges, events),
            {"upload": 20e-6, "extract.softmax": 40e-6, "": 0.0})


def test_overlapping_device_intervals_count_once():
    ranges = [("method", 0, 100)]
    events = [_host(0, 100), _dev(10, 50), _dev(20, 60), _dev(55, 70),
              ("Memcpy HtoD", True, 65, 80)]
    got = idle.idle_by_span(ranges, events)
    # busy [10, 80]
    _approx(got, {"method": 30e-6, "": 0.0})


def test_a_window_with_no_annotation_goes_wholly_to_no_span():
    events = [_host(5, 100), _dev(20, 40), _dev(60, 70)]
    _approx(idle.idle_by_span([], events), {"": 65e-6})


def test_an_empty_trace_has_no_idle_time():
    assert idle.idle_by_span([], []) == {"": 0.0}


def test_a_stretch_with_no_span_open_between_spans():
    ranges = [("sampling", 0, 10), ("method", 30, 50)]
    events = [_host(0, 50)]
    _approx(idle.idle_by_span(ranges, events),
            {"sampling": 10e-6, "method": 20e-6, "": 20e-6})


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_parts_sum_to_the_window_less_the_busy_time(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    events = []
    for _ in range(200):
        s = float(rng.uniform(0, 10000))
        events.append((f"op{rng.integers(5)}", bool(rng.integers(2)), s,
                       s + float(rng.exponential(40))))
    ranges = []
    # nested ranges on one thread: a few outer ones, each with inner ones
    for k in range(20):
        s = 500.0 * k
        ranges.append(("method", s, s + 450))
        ranges.append(("em.step", s + 50, s + 300))
        ranges.append(("newton", s + 60, s + 200))
    got = idle.idle_by_span(ranges, events)
    lo = min([e[2] for e in events] + [r[1] for r in ranges])
    hi = max([e[3] for e in events] + [r[2] for r in ranges])
    busy = trace.reduce_events(events, 1.0)["busy_s"]
    assert sum(got.values()) == pytest.approx((hi - lo) * 1e-6 - busy,
                                              rel=1e-9)
    assert all(v >= 0 for v in got.values())
    assert {"method", "em.step", "newton", ""} == set(got)


def test_annotations_read_the_cpu_ranges_of_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).add(1)
    got = {name: (s, t) for name, s, t in idle.annotations(prof)}
    assert set(got) == {"outer", "inner"}
    assert got["outer"][0] <= got["inner"][0] <= got["inner"][1] <= (
        got["outer"][1])
    # the annotations are none of the events the busy time reads
    assert not {"outer", "inner"} & {e[0] for e in trace.spans(prof)}


def _record(by_span, busy=0.2, untraced=1.0, units=2):
    return {"trace": {"busy_s": busy, "window_s": 2.0, "kernels": 1,
                      "device_ops": {}, "calls": {}, "idle_gaps": [],
                      "idle_by_span": by_span},
            "untraced_s": untraced, "trace_batches": units}


TASK_SPLIT = {"newton": 0.4, "em.step": 0.3, "host_wait": 0.1, "upload": 0.2,
              "class_pools": 0.25, "sampling": 0.15, "method": 0.05,
              "": 0.4}


@pytest.mark.parametrize("name", TASK_READERS + EXTRACT_READERS)
def test_each_reader_reads_nothing_without_idle_by_span(name):
    read = spec.metric_reader(name)
    rec = _record({})
    del rec["trace"]["idle_by_span"]
    assert read(rec) is None
    assert read({"untraced_s": 1.0, "trace_batches": 2}) is None
    assert read(dict(_record(TASK_SPLIT), untraced_s=None)) is None


@pytest.mark.parametrize("name", TASK_READERS)
def test_a_zs_reader_needs_every_span_of_the_cell(name):
    # a program without em.step, upload and class_pools (the spans before
    # them only)
    split = {k: v for k, v in TASK_SPLIT.items()
             if k not in ("em.step", "upload", "class_pools")}
    assert spec.metric_reader(name)(_record(split)) is None
    assert spec.metric_reader(name)(_record(TASK_SPLIT, units=0)) is None


def test_the_zs_readings_sum_to_the_untraced_idle_time_per_batch():
    rec = _record(TASK_SPLIT, busy=0.2, untraced=1.0, units=2)
    got = {n: spec.metric_reader(n)(rec) for n in TASK_READERS}
    # 0.8 s untraced idle over 2 batches: 400 ms, split as traced
    assert sum(got.values()) == pytest.approx(400.0)
    traced = sum(TASK_SPLIT.values())
    assert got["newton_idle_ms_per_batch.zs"] == pytest.approx(
        400.0 * 0.4 / traced)
    assert got["other_idle_ms_per_batch.zs"] == pytest.approx(
        400.0 * 0.6 / traced)


def test_the_extraction_readings_sum_to_the_untraced_idle_time_a_pass():
    split = {"extract.softmax": 0.7, "extract.encode": 0.05,
             "extract.first_issue": 0.01, "host_wait": 0.02, "": 0.02}
    rec = _record(split, busy=2.0, untraced=2.8)
    del rec["trace_batches"]
    got = {n: spec.metric_reader(n)(rec) for n in EXTRACT_READERS}
    assert sum(got.values()) == pytest.approx(800.0)
    assert got["issue_idle_ms_per_pass.extract"] == pytest.approx(
        800.0 * 0.06 / 0.8)
    # no idle time at all reads 0 in each
    none = dict(split, **{k: 0.0 for k in split})
    assert all(spec.metric_reader(n)(_record(none)) == 0.0
               for n in EXTRACT_READERS)


def cpu_traced(fn):
    """``trace.traced`` with the CPU's profiler and the idle time by span
    added to the reduction: on the CPU nothing runs on a device, so the
    whole window is idle and each span's part is its host time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    events = trace.spans(prof)
    tr = trace.reduce_events(events, wall)
    tr["idle_by_span"] = idle.idle_by_span(idle.annotations(prof), events)
    return out, tr


def test_the_tiny_zs_cell_puts_its_idle_time_down_to_its_spans(
        zs_cell, monkeypatch):
    monkeypatch.setattr(task_eval.trace, "traced", cpu_traced)
    record = task_eval.run(zs_cell, SEED, 0.0, True, device="cpu")
    assert record["correct"]
    by_span = record["trace"]["idle_by_span"]
    assert set(idle.TASK_SPANS) <= set(by_span)
    assert {"sampling", "method"} <= set(by_span)
    assert by_span["newton"] > 0 and by_span["em.step"] > 0
    got = {n: spec.metric_reader(n)(record) for n in TASK_READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    per_batch = 1e3 * record["untraced_s"] / record["trace_batches"]
    assert sum(got.values()) == pytest.approx(per_batch, rel=1e-9)


def test_the_tiny_extraction_cell_puts_its_idle_time_down_to_its_spans(
        extract_cell, monkeypatch):
    monkeypatch.setattr(extraction.trace, "traced", cpu_traced)
    record = extraction.run(extract_cell, SEED, 0.0, True, device="cpu")
    assert record["correct"]
    by_span = record["trace"]["idle_by_span"]
    assert set(idle.EXTRACT_SPANS) <= set(by_span)
    assert by_span["extract.softmax"] > 0
    got = {n: spec.metric_reader(n)(record) for n in EXTRACT_READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert sum(got.values()) == pytest.approx(1e3 * record["untraced_s"],
                                              rel=1e-9)
