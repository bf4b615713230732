"""Shared set-up of the benchmark's own tests: the benchmark and the repo
root on sys.path, and the cells cut to a size the CPU runs in seconds.

Run from the repo root: ``python -m pytest benchmark/tests -q``."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402


def tiny_task_cell(name):
    """A task cell at 40 classes: 2 evaluations of 2 batches of 2 tasks,
    10 queries, every task checked."""
    cell = spec.Cell(spec.load_benchmark(), "em_dirichlet_imagenet.zs")
    config, traffic = name.rsplit(".", 1)
    assert config == cell.config["name"]
    # the few-shot traffic is kept for a later cell (PERF.md): its file
    # drives the harness's few-shot path here
    cell.traffic = spec.load_json(os.path.join(BENCH, "traffic",
                                               f"{traffic}.json"))
    cell.config.update(n_class=40, test_per_class=12, train_per_class=6,
                       features=dict(cell.config["features"], embed_dim=64))
    cell.traffic.update(evaluations=2, number_tasks=4, batch_size=2,
                        n_query=10, check_tasks=8)
    return cell


def tiny_extraction_cell():
    """The extraction cell with 2-layer towers, 16 prompts and 40 images
    in batches of 16 (a ragged last batch), 8 of them checked."""
    cell = spec.Cell(spec.load_benchmark(), "clip_vit_b16.extract")
    cfg = cell.config
    cfg.update(backbone="tiny", n_class=16,
               vision=dict(cfg["vision"], layers=2),
               text=dict(cfg["text"], layers=2))
    cell.traffic.update(images=40, batch_size=16, check_images=8)
    return cell


@pytest.fixture
def zs_cell():
    return tiny_task_cell("em_dirichlet_imagenet.zs")


@pytest.fixture
def fs_cell():
    return tiny_task_cell("em_dirichlet_imagenet.fs4")


@pytest.fixture
def extract_cell():
    return tiny_extraction_cell()
