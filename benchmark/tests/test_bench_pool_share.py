"""The reader of ``pool_kernel_share.rn50``: the share of the image
tower's pools of a window above 1 that the port's NHWC pool kernel ran,
from the counters ``resnet.kernel_pools`` and ``resnet.pools`` in a run's
``phases``. It reads 100 where every pool ran in the kernel, and nothing
where the record lacks the counters (a program from before them). The
tiny RN50 cell on the CPU carries the counters into its record: 7 pools a
forward, none in the kernel."""

import pytest

from harness import extraction, extraction_phases, spec

from test_bench_rn50 import SEED, fake_traced, rn50_cell  # noqa: F401

NAME = "pool_kernel_share.rn50"
# RN50's pools of a window above 1: the stem's and two in each of the
# three strided blocks (layer1's shortcut pools at window 1)
RN50_POOLS = 7


@pytest.mark.parametrize("phases,want", [
    ({"resnet.pools": RN50_POOLS, "resnet.kernel_pools": RN50_POOLS}, 100.0),
    ({"resnet.pools": 3 * RN50_POOLS, "resnet.kernel_pools": 3 * RN50_POOLS},
     100.0),
    ({"resnet.pools": 2 * RN50_POOLS, "resnet.kernel_pools": 0}, 0.0),
    ({"resnet.convs": 55, "resnet.fused_convs": 54, "host_wait": 0.1}, None),
    ({"resnet.pools": RN50_POOLS}, None),
    ({}, None)],
    ids=["card-one-forward", "card-three-forwards", "cpu", "no-counters",
         "no-kernel-counter", "empty"])
def test_the_reader(phases, want):
    got = spec.metric_reader(NAME)({"passes": 1, "phases": phases})
    assert got == (None if want is None else pytest.approx(want))


def test_a_record_without_phases_reads_nothing():
    assert spec.metric_reader(NAME)({"passes": 1, "images": 40}) is None


def test_the_metric_is_declared_for_the_rn50_cell_only():
    bench = spec.load_benchmark()
    entry = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1
    assert entry[0]["workloads"] == ["clip_rn50.extract"]
    assert entry[0]["moves"] == "image_ms" and entry[0]["layer"] == "Towers"
    assert bench["per_layer"][-1]["name"] == NAME


def test_the_tiny_rn50_cell_carries_the_counters(rn50_cell,  # noqa: F811
                                                 monkeypatch):
    monkeypatch.setattr(extraction.trace, "traced", fake_traced)
    record = extraction_phases.run(rn50_cell, SEED, 0.0, True, device="cpu")
    phases = record["phases"]
    forwards = phases["extract.batches"]
    assert phases["resnet.pools"] == RN50_POOLS * forwards
    assert phases["resnet.kernel_pools"] == 0
    assert spec.metric_reader(NAME)(record) == 0.0
