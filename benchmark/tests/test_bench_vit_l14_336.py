"""The ViT-L/14@336px extraction cell: its configuration is the port's own
ViT-L/14@336px; it reports the ViT-B/16 cell's per-layer metrics
(``k4b_roofline``, ``mfu.extract``, ``idle_share.extract``), whose readers
give the hand value on a record of this cell's reference and nothing where
the trace is absent; its reference bounds K4b by the larger of each
launch's bytes and products; BENCHMARK.json runs it on one chip under
``image_ms``; and a CPU run of the cell cut to a tiny tower puts the
tower's counters of the window's passes into the record."""

import pytest
import torch

from harness import extraction, extraction_phases, spec, work

torch.set_num_threads(4)
SEED = 2 ** 31 + 3361
CELL = "clip_vit_l14_336.extract"
READERS = ("k4b_roofline", "mfu.extract", "idle_share.extract")
KERNEL = ("void tclip::attention_blocked_bf16<1, false>(CUtensorMap_st, float "
          "const*, __nv_bfloat16*, int, int, int, float)")


@pytest.fixture
def cell():
    return spec.Cell(spec.load_benchmark(), CELL)


def test_the_configuration_is_the_ports_vit_l14_336(cell):
    from transductive_clip_tpu_torch.models.clip.config import CLIP_CONFIGS

    cfg = cell.config
    assert cfg["reduced"] == [] and cell.config_entry["reduced"] == []
    assert cfg["runner"] == "extraction_phases"
    assert cfg["reference"] == "clip_vit_l14_336"
    assert extraction._program_config(cfg) == CLIP_CONFIGS["ViT-L/14@336px"]
    assert cell.traffic == {"images": 50000, "batch_size": 512,
                            "check_images": 512}


def test_the_cell_runs_on_one_chip_under_image_ms(cell):
    bench = spec.load_benchmark()
    assert cell.chips == 1
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["image_ms"]["workloads"]
    assert [m["name"] for m in cell.metrics(False)] == [
        "image_ms", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in cell.metrics(True)] == list(READERS)
    for m in cell.metrics(True):
        assert m["workloads"] == ["clip_vit_b16.extract", CELL]
        assert m["moves"] == "image_ms"


def _record():
    return {
        "window_s": 50.0, "images": 50000, "passes": 1, "untraced_s": 50.0,
        "image_flops": 381_919_789_056, "k4b_bound_s": 1.693,
        "phases": {"extract.encode": 49.0, "host_wait": 0.3,
                   "vit.attention": 2352.0, "vit.kernel_attention": 2352.0},
        "trace": {"busy_s": 48.0, "window_s": 55.0, "kernels": 10,
                  "device_ops": {KERNEL: 3.386, "other": 44.6},
                  "calls": {KERNEL: 2352, "other": 100000}},
    }


def test_the_readers_hand_values():
    rec = _record()
    read = {name: spec.metric_reader(name)(rec) for name in READERS}
    assert read["k4b_roofline"] == pytest.approx(50.0)
    assert read["mfu.extract"] == pytest.approx(
        100.0 * 50000 * 381_919_789_056 / 50.0 / 989e12)
    assert read["idle_share.extract"] == pytest.approx(4.0)


def test_the_readers_need_no_counters_and_find_nothing_without_a_trace():
    """A program without the tower's counters (its phases hold the
    extraction's spans only, as on a port from before them) reads the same;
    in an untraced run the trace readers are silent; a trace without K4b
    leaves its roofline out."""
    rec = _record()
    bare = _record()
    bare["phases"] = {"extract.encode": 49.0, "host_wait": 0.3}
    for name in READERS:
        assert spec.metric_reader(name)(bare) == pytest.approx(
            spec.metric_reader(name)(rec))
    untraced = dict(rec, trace=None)
    for name in ("k4b_roofline", "idle_share.extract"):
        assert spec.metric_reader(name)(untraced) is None
    roofline = spec.metric_reader("k4b_roofline")
    assert roofline(dict(rec, trace=dict(rec["trace"], device_ops={
        "other": 1.0}, calls={"other": 3}))) is None
    assert spec.metric_reader("mfu.extract")(dict(rec, images=0)) is None


def test_k4b_bound_is_the_larger_of_bytes_and_products_a_batch(cell):
    arch = cell.reference()
    cfg = cell.config
    bs = [512] * 97 + [336]
    got = arch.work_counts(cfg, bs)
    assert got["image_flops"] == 381_919_789_056
    n, width = 577, 1024
    by_bytes = 24 * sum(work.attention_bytes(b, n, width) for b in bs) \
        / work.PEAK_BYTES_PER_S
    by_products = 24 * sum(4 * b * n * n * width for b in bs) \
        / work.PEAK_FLOPS_BF16
    # at n = 577 the bytes bound it, 2% above the products
    assert got["k4b_bound_s"] == pytest.approx(by_bytes)
    assert got["k4b_bound_s"] == pytest.approx(1.693, abs=5e-4)
    assert by_products == pytest.approx(1.655, abs=5e-4)
    # at twice the tokens the products bound it
    wide = dict(cfg, vision=dict(cfg["vision"], image_size=476))
    m = (476 // 14) ** 2 + 1
    assert arch.work_counts(wide, [512])["k4b_bound_s"] == pytest.approx(
        24 * 4 * 512 * m * m * width / work.PEAK_FLOPS_BF16)
    assert 24 * work.attention_bytes(512, m, width) / work.PEAK_BYTES_PER_S \
        < arch.work_counts(wide, [512])["k4b_bound_s"]


def test_a_cpu_run_counts_the_towers_attention(cell, monkeypatch):
    """The cell cut to a two-layer tower of width 128 at 56 px: the
    record's phases carry the tower's counters of the window's passes only
    (one a layer a batch, no K4b launch on the CPU), and the run is
    correct."""
    cfg = cell.config
    cfg.update(backbone="tiny-vit-l14", n_class=16,
               vision=dict(cfg["vision"], image_size=56, width=128, heads=2,
                           layers=2),
               text=dict(cfg["text"], width=64, heads=1, layers=2))
    cell.traffic.update(images=40, batch_size=16, check_images=8)

    def fake_traced(fn):
        fn()
        return None, {"busy_s": 0.5, "window_s": 1.0, "kernels": 3,
                      "device_ops": {"op": 0.5}, "calls": {"op": 3},
                      "idle_gaps": []}

    monkeypatch.setattr(extraction.trace, "traced", fake_traced)
    record = extraction_phases.run(cell, SEED, 0.0, True, device="cpu")
    assert record["correct"]
    phases = record["phases"]
    assert record["passes"] == 1
    assert phases["vit.attention"] == 2 * 3
    assert phases["vit.kernel_attention"] == 0
    read = {name: spec.metric_reader(name)(record) for name in READERS}
    assert read["k4b_roofline"] is None
    assert read["mfu.extract"] > 0 and read["idle_share.extract"] is not None
