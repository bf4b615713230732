"""The RN50 extraction cell cut to a tiny ModifiedResNet on the CPU: its
runner (harness/extraction_phases.py) puts the program's phases of the
window's passes into the record, and only theirs; its readers return None
on a record without them; a program whose extraction records no phases
still runs the cell; the run takes the reference's images and puts the
harness's back; the check holds the tiny program and fails its fp8
control and rows handed to the wrong image, and a check that cannot tell
images apart makes the run not correct."""

import numpy as np
import pytest
import torch

from harness import clip_inputs, extraction, extraction_phases, spec

torch.set_num_threads(4)
SEED = 2 ** 31 + 4321
CELL_METRICS = ("image_ms", "mfu.rn50", "idle_share.rn50",
       "issue_ms_per_batch.rn50", "host_softmax_ms_per_pass.rn50")


@pytest.fixture
def rn50_cell():
    """clip_rn50.extract with a 64-pixel tower of width 16, one block a
    stage, 2-layer text tower, 16 prompts and 40 images in batches of 16
    (a ragged last batch), 8 of them checked."""
    cell = spec.Cell(spec.load_benchmark(), "clip_rn50.extract")
    cfg = cell.config
    cfg.update(backbone="tiny-rn", embed_dim=64, n_class=16,
               vision=dict(cfg["vision"], image_size=64, width=16, heads=8,
                           resnet_layers=[1, 1, 1, 1]),
               text=dict(cfg["text"], layers=2))
    cell.traffic.update(images=40, batch_size=16, check_images=8)
    return cell


def fake_traced(fn):
    """The traced pass run as it is, without a profiler (none on the
    CPU), and a reduced trace of one device operation."""
    fn()
    return None, {"busy_s": 0.5, "window_s": 1.0, "kernels": 3,
                  "device_ops": {"op": 0.5}, "calls": {"op": 3},
                  "idle_gaps": []}


def test_the_record_carries_the_window_passes_phases(rn50_cell,
                                                     monkeypatch):
    monkeypatch.setattr(extraction.trace, "traced", fake_traced)
    record = extraction_phases.run(rn50_cell, SEED, 0.0, True, device="cpu")
    assert record["correct"]
    passes, phases = record["passes"], record["phases"]
    assert passes == 1
    # one timer a pass of the window: the warm-up made none, the traced
    # pass's is left out
    assert phases["extract.batches"] == 3 * passes
    assert phases["extract.images"] == 40 * passes
    assert {"extract.encode", "extract.first_issue", "extract.softmax",
            "host_wait"} <= set(phases)
    assert phases["extract.first_issue"] <= phases["extract.encode"]
    line = {m: spec.metric_reader(m)(record) for m in CELL_METRICS}
    assert all(v is not None for v in line.values()), line
    assert all(line[m] > 0 for m in CELL_METRICS
               if m != "idle_share.rn50"), line
    assert line["issue_ms_per_batch.rn50"] == pytest.approx(
        1e3 * phases["extract.first_issue"])
    assert line["host_softmax_ms_per_pass.rn50"] == pytest.approx(
        1e3 * phases["extract.softmax"])
    assert line["idle_share.rn50"] == pytest.approx(
        100.0 * (1 - 0.5 / record["untraced_s"]))


def test_the_readers_find_nothing_without_phases():
    bare = {"passes": 2, "images": 100, "window_s": 1.0, "trace": None}
    for name in ("issue_ms_per_batch.rn50", "host_softmax_ms_per_pass.rn50"):
        read = spec.metric_reader(name)
        assert read(bare) is None
        assert read(dict(bare, phases={})) is None
        assert read(dict(bare, phases={"host_wait": 0.1,
                                       "extract.encode": 0.2})) is None
    assert spec.metric_reader("mfu.rn50")(bare) is None
    assert spec.metric_reader("idle_share.rn50")(bare) is None
    assert spec.metric_reader("mfu.rn50")(
        dict(bare, image_flops=1e9)) == pytest.approx(
        100.0 * 100 * 1e9 / 989e12)


def test_a_program_without_the_extraction_phases_runs_the_cell(
        rn50_cell, monkeypatch):
    """The extraction as it was before it recorded phases: the runner
    leaves ``phases`` empty, its readers are silent, and the program's
    module is restored."""
    from transductive_clip_tpu_torch.eval import extraction as program

    own_timer = program.PhaseTimer

    def untimed(model, batches, targets, text_features=None, write=True):
        pending, labels = [], []
        for images, batch_labels in batches:
            pending.append(model.encode_image_batch(images))
            labels.append(np.asarray(batch_labels))
        emb = torch.cat(pending).cpu().numpy()
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        out = np.exp(targets[0][0] * emb @ text_features.T)
        out /= out.sum(-1, keepdims=True)
        if write:
            program.save_feature_cache(targets[0][1], out,
                                       np.concatenate(labels))
        return emb, np.concatenate(labels)

    monkeypatch.setattr(program, "extract_to_caches", untimed)
    record = extraction_phases.run(rn50_cell, SEED, 0.0, False, device="cpu")
    assert record["correct"] and record["phases"] == {}
    for name in ("issue_ms_per_batch.rn50", "host_softmax_ms_per_pass.rn50"):
        assert spec.metric_reader(name)(record) is None
    assert program.PhaseTimer is own_timer


def test_the_rn50_control_is_not_correct(rn50_cell):
    checks, ok = extraction_phases.control(rn50_cell, SEED, "cpu")
    assert not ok
    assert checks["log_softmax_gap"]["value"] > \
        checks["log_softmax_gap"]["limit"]
    assert clip_inputs.images.__module__ == clip_inputs.__name__


def _reference_rows(cell, seed):
    """The reference's softmax features of the images a run checks."""
    cfg, arch = cell.config, cell.reference()
    sd = clip_inputs.state_dict(cfg, arch.layout, seed, "cpu")
    tokens = clip_inputs.prompt_tokens(seed, int(cfg["n_class"]),
                                       cfg["text"]["context_length"],
                                       cfg["text"]["vocab_size"], "cpu")
    images = arch.images(seed, 8, cfg["vision"]["image_size"], "cpu")
    return extraction.reference_softmax(cfg, arch, sd, tokens, images)


@pytest.mark.parametrize("seed", [SEED, 5])
def test_rows_handed_to_the_wrong_image_are_not_correct(rn50_cell, seed):
    ref = _reference_rows(rn50_cell, seed)
    cfg = rn50_cell.config
    moved = [np.roll(ref, 1, axis=0)]
    checks, ok = extraction.judge(cfg, moved, ref)
    assert not ok
    assert extraction_phases.judge_telling_images_apart(cfg, [ref], ref)[1]
    assert not extraction_phases.judge_telling_images_apart(
        cfg, moved, ref)[1]


def test_a_check_that_cannot_tell_images_apart_is_not_correct(rn50_cell):
    """With a limit wide enough to pass rows moved by one image, even the
    reference's own rows are not correct."""
    ref = _reference_rows(rn50_cell, SEED)
    cfg = dict(rn50_cell.config, limits={"log_softmax_gap": 1e3})
    checks, ok = extraction_phases.judge_telling_images_apart(cfg, [ref],
                                                              ref)
    assert checks["log_softmax_gap"]["value"] == 0.0
    assert not ok


def test_the_run_takes_the_references_images_and_puts_the_harness_back(
        rn50_cell, monkeypatch):
    made = []
    own = rn50_cell.reference().images
    harness_images, harness_judge = clip_inputs.images, extraction.judge

    def recorded(seed, n, size, device):
        made.append((seed, n, size))
        return own(seed, n, size, device)

    monkeypatch.setattr(type(rn50_cell), "reference",
                        lambda self: _with_images(recorded))
    record = extraction_phases.run(rn50_cell, SEED, 0.0, False, device="cpu")
    assert record["correct"]
    assert made == [(SEED, 40, 64)]
    assert clip_inputs.images is harness_images
    assert extraction.judge is harness_judge


def _with_images(images):
    """The RN50 reference module with ``images`` replaced."""
    mod = spec.load_reference("clip_rn50")
    mod.images = images
    return mod
