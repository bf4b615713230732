"""The reduction of a profiler trace: busy time as the union of the device
operations' intervals, launches, and the idle gaps named by the innermost
host operation under way."""

from harness import trace


def test_reduce_events():
    events = [("k1", True, 0, 10), ("k2", True, 5, 20),
              ("Memcpy HtoD", True, 40, 50), ("k3", True, 100, 110),
              ("aten::to", False, 15, 60),
              ("evaluate", False, 0, 200),
              ("aten::item", False, 55, 100)]
    r = trace.reduce_events(events, 0.25)
    # [0, 20] + [40, 50] + [100, 110] microseconds
    assert abs(r["busy_s"] - 40e-6) < 1e-12
    assert r["window_s"] == 0.25
    assert r["kernels"] == 3
    assert r["calls"]["k1"] == 1
    assert [g[0] for g in r["idle_gaps"]] == ["aten::item", "aten::to"]
    assert abs(r["idle_gaps"][0][1] - 50e-6) < 1e-12
    assert trace.named(r, "k") == (r["device_ops"]["k1"] + r["device_ops"]["k2"]
                                   + r["device_ops"]["k3"], 3)
    b = trace.breakdown(r)
    assert [k for k, _ in b["device_ops"]][0] == "k2"
    assert len(b["device_ops"]) <= trace.TOP


def test_spans_read_the_raw_events():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).add(1)
    got = trace.spans(prof)
    assert any(name == "aten::add" and not dev and end >= start
               for name, dev, start, end in got)


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (0, 3), (2, 4), (7, 9)]) == [[0, 4], [5, 9]]
