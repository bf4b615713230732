"""A run driven on the CPU at a tiny size, past the harness's look for a
chip: the result line's keys, the import isolation, the controls, and the
faults of the timed path that the check has to catch."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, tiny_task_cell

from harness import extraction, main, task_eval

torch.set_num_threads(4)
SEED = 2 ** 31 + 12345


def run_task(cell):
    return task_eval.run(cell, SEED, 0.0, False, device="cpu")


def run_extraction(cell):
    return extraction.run(cell, SEED, 0.0, False, device="cpu")


def test_result_line_keys(zs_cell):
    record = run_task(zs_cell)
    assert record["correct"]
    line = main.result_line(zs_cell, record, False, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"task_ms.zs", "peak_mem_gib", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["attempted"] == 8 and line["failed"] == 0
    json.dumps(line)
    record["trace"] = {"busy_s": 0.5, "window_s": 1.0, "kernels": 40,
                       "device_ops": {"auction_kernel": 0.1},
                       "calls": {"auction_kernel": 2}, "idle_gaps": []}
    record["trace_batches"] = 2
    record["untraced_s"] = 0.8
    traced = main.result_line(zs_cell, record, True, "cpu")
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["metrics"]) == {
        "sampling_ms_per_batch.zs", "host_syncs_per_batch.zs",
        "kernels_per_batch.zs", "auction_roofline", "mfu.zs",
        "idle_share.zs"}
    # the idle share is read against the untraced time of the same work
    assert traced["metrics"]["idle_share.zs"]["value"] == pytest.approx(
        100.0 * (1 - 0.5 / 0.8))


def test_few_shot_and_extraction_runs_are_correct(fs_cell, extract_cell):
    assert run_task(fs_cell)["correct"]
    record = run_extraction(extract_cell)
    assert record["correct"]
    assert record["checks"]["log_softmax_gap"]["value"] < 0.1


_ISOLATION = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
sys.path.insert(0, {tests!r})
from conftest import tiny_task_cell, tiny_extraction_cell
from harness import extraction, main, task_eval
import control
task_eval.run(tiny_task_cell("em_dirichlet_imagenet.zs"), 5, 0.0, False, "cpu")
task_eval.run(tiny_task_cell("em_dirichlet_imagenet.fs4"), 5, 0.0, False, "cpu")
extraction.run(tiny_extraction_cell(), 5, 0.0, False, "cpu")
print(main.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = _ISOLATION.format(bench=BENCH, root=ROOT,
                             tests=BENCH + "/tests")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "transductive_clip_tpu_torch_like", None)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "transductive_clip_tpu.ops", None)
    assert main.forbidden_modules() == ["transductive_clip_tpu.ops"]


def test_the_extraction_control_is_not_correct(extract_cell):
    import control

    checks, ok = control.extraction_control(extract_cell, SEED, "cpu")
    assert not ok
    assert checks["log_softmax_gap"]["value"] > \
        checks["log_softmax_gap"]["limit"]


def control_size_cell():
    """The zero-shot cell at 100 classes, 40 tasks in batches of 20, every
    task checked: a size at which the TF32 control flips predictions."""
    from harness import spec

    cell = spec.Cell(spec.load_benchmark(), "em_dirichlet_imagenet.zs")
    cell.config.update(n_class=100, test_per_class=50)
    cell.traffic.update(evaluations=1, number_tasks=40, batch_size=20,
                        check_tasks=40)
    return cell


def test_the_task_control_is_not_correct():
    """The reference with its products' operands rounded to TF32 fails the
    cell's check (the rounding is emulated, so it runs on the CPU too)."""
    import control

    checks, ok = control.task_control(control_size_cell(), SEED, "cpu")
    assert set(checks) == {"bad_tasks", "pred_mismatch_pct",
                           "acc_mismatch_pct", "acc_vs_own_preds"}
    assert not ok
    assert checks["pred_mismatch_pct"]["value"] > \
        checks["pred_mismatch_pct"]["limit"]


def test_a_run_at_the_controls_size_is_correct():
    assert run_task(control_size_cell())["correct"]


# -- faults of the timed path that the check has to catch -----------------

@pytest.mark.parametrize("kind", ["zs", "fs"])
def test_fault_state_unchanged(monkeypatch, kind):
    """The M-step hands back the Dirichlet parameters it was given."""
    from transductive_clip_tpu_torch.methods.few_shot import (
        em_dirichlet as fs_em,
    )
    from transductive_clip_tpu_torch.methods.zero_shot import (
        em_dirichlet as zs_em,
    )

    monkeypatch.setattr(zs_em if kind == "zs" else fs_em, "update_alpha",
                        lambda alpha0, y, **kw: alpha0.clone())
    record = run_task(tiny_task_cell("em_dirichlet_imagenet.zs" if kind == "zs"
                                     else "em_dirichlet_imagenet.fs4"))
    assert not record["correct"]
    assert record["checks"]["pred_mismatch_pct"]["value"] > 0


@pytest.mark.parametrize("kind", ["zs", "fs"])
def test_fault_half_the_batch_left_out(monkeypatch, kind):
    """The method solves the first half of a batch's tasks and hands their
    answers on for the rest."""
    from transductive_clip_tpu_torch.methods.few_shot import (
        em_dirichlet as fs_em,
    )
    from transductive_clip_tpu_torch.methods.zero_shot import (
        em_dirichlet as zs_em,
    )

    cell = tiny_task_cell("em_dirichlet_imagenet.zs" if kind == "zs"
                          else "em_dirichlet_imagenet.fs4")
    cell.traffic.update(number_tasks=8, batch_size=4, check_tasks=16)
    owner = zs_em.EM_DIRICHLET if kind == "zs" else fs_em.EM_DIRICHLET
    infer = owner._infer

    def half(self, task):
        n = task["x_q"].shape[0]
        first = {k: (v[: n // 2] if torch.is_tensor(v) and v.dim() > 0
                     and v.shape[0] == n else v) for k, v in task.items()}
        u, crit, n_exec = infer(self, first)
        return torch.cat([u, u])[:n], crit, n_exec

    monkeypatch.setattr(owner, "_infer", half)
    record = run_task(cell)
    assert not record["correct"]


def test_fault_an_answer_altered_where_it_is_produced(monkeypatch, zs_cell):
    """The matching renames one query of every batch to another class."""
    from transductive_clip_tpu_torch.methods import base

    rows = base.hungarian_matching_rows

    def altered(preds, row_idx, row_probs, n_class):
        out = rows(preds, row_idx, row_probs, n_class)
        out[0, 0] = (out[0, 0] + 1) % n_class
        return out

    monkeypatch.setattr(base, "hungarian_matching_rows", altered)
    record = run_task(zs_cell)
    assert not record["correct"]
    assert record["checks"]["pred_mismatch_pct"]["value"] > 0


def test_fault_an_accuracy_altered_where_it_is_produced(monkeypatch,
                                                         zs_cell):
    """Right predictions, a wrong accuracy."""
    from transductive_clip_tpu_torch.methods import base

    host_accuracy = base._host_accuracy
    monkeypatch.setattr(base, "_host_accuracy",
                        lambda p, y: host_accuracy(p, y) * np.float32(0.5))
    record = run_task(zs_cell)
    assert not record["correct"]
    assert record["checks"]["acc_mismatch_pct"]["value"] > 0


def test_fault_extraction_features_altered(monkeypatch, extract_cell):
    """Every embedding the image tower hands back carries noise of a tenth
    of its spread."""
    from transductive_clip_tpu_torch.models.clip.model import TorchCLIP

    encode = TorchCLIP._encode
    g = torch.Generator().manual_seed(0)

    def nudged(self, images):
        out = encode(self, images)
        return out + 0.1 * out.std() * torch.randn(out.shape, generator=g)

    monkeypatch.setattr(TorchCLIP, "_encode", nudged)
    record = run_extraction(extract_cell)
    assert not record["correct"]


def test_fault_extraction_half_the_batch_left_out(monkeypatch, extract_cell):
    """Half of each image batch is encoded and its rows handed on for the
    rest."""
    from transductive_clip_tpu_torch.models.clip.model import TorchCLIP

    encode = TorchCLIP._encode

    def half(self, images):
        n = images.shape[0]
        out = encode(self, images[: (n + 1) // 2])
        return torch.cat([out, out])[:n]

    monkeypatch.setattr(TorchCLIP, "_encode", half)
    record = run_extraction(extract_cell)
    assert not record["correct"]
