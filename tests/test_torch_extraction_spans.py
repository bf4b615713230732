"""The spans and counters of the port's feature extraction
(``eval.extraction.extract_to_caches``): under an active ``PhaseTimer`` a
pass records ``extract.batches`` and ``extract.images`` equal to hand
counts, ``extract.encode``, ``extract.first_issue`` and ``host_wait`` once
each, and ``extract.softmax`` once for the normalisation and once a
softmax target; each cache is written as soon as it is made, outside the
span; the extraction's own timer holds the same and is active only inside
the call; a timer that is not active records nothing."""

import contextlib

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.core import profiling
from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.eval import extraction
from transductive_clip_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.model import (
    TorchCLIP,
    init_random_state_dict,
)

torch.set_num_threads(2)

TINY = CLIPConfig(
    name="tiny-rn",
    embed_dim=32,
    vision=CLIPVisionConfig(image_size=32, width=16, heads=4, is_resnet=True,
                            resnet_layers=(1, 1, 1, 1)),
    text=CLIPTextConfig(vocab_size=64, context_length=8, width=32, layers=1,
                        heads=4),
)
SIZES = (4, 4, 3)          # a ragged last batch
SPANS = ("extract.encode", "extract.first_issue", "host_wait")


@pytest.fixture(scope="module")
def model():
    return TorchCLIP(TINY, init_random_state_dict(TINY, seed=0),
                     compute_dtype=torch.float32, attention_impl="xla",
                     device="cpu")


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
             np.arange(n)) for n in SIZES]


def _text():
    text = np.random.default_rng(1).normal(size=(5, TINY.embed_dim))
    return (text / np.linalg.norm(text, axis=-1, keepdims=True)).astype(
        np.float32)


def _one_pass(model):
    return extraction.extract_to_caches(model, _batches(), [(30.0, "x")],
                                        _text(), write=False)


def _check_counts(timer, passes):
    assert timer.totals["extract.batches"] == len(SIZES) * passes
    assert timer.totals["extract.images"] == sum(SIZES) * passes
    assert {"extract.batches", "extract.images"} <= timer.counters
    for name in SPANS:
        assert timer.counts[name] == passes, name
        assert name not in timer.counters and timer.totals[name] >= 0
    # the normalisation and the one softmax target of ``_one_pass``
    assert timer.counts["extract.softmax"] == 2 * passes
    assert timer.totals["extract.first_issue"] <= \
        timer.totals["extract.encode"]


def test_a_pass_records_its_spans_and_counts_under_an_active_timer(model):
    outer = PhaseTimer()
    with outer.active():
        _one_pass(model)
        emb, labels = _one_pass(model)
    _check_counts(outer, passes=2)
    assert emb.shape == (sum(SIZES), TINY.embed_dim)
    assert labels.shape == (sum(SIZES),)


def test_the_extractions_own_timer_is_active_inside_the_call_only(
        model, monkeypatch):
    made = []

    class Recorded(PhaseTimer):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(extraction, "PhaseTimer", Recorded)
    idle = PhaseTimer()            # made, never made active
    assert profiling._sink is None
    _one_pass(model)
    assert profiling._sink is None
    assert len(made) == 1
    _check_counts(made[0], passes=1)
    assert not idle.totals and not idle.counts


def test_span_and_count_are_inert_with_no_timer_active():
    assert profiling._sink is None
    assert profiling.span("extract.encode") is profiling._OFF
    profiling.count("extract.batches", 3)
    assert profiling._sink is None


def test_each_cache_is_written_as_it_is_made_outside_the_span(
        model, monkeypatch):
    """Three targets: the embeddings and two temperatures. Each is written
    before the next is computed, and no write falls inside a record of
    ``extract.softmax``."""
    events = []
    timer = PhaseTimer()

    class Watched(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name):
            events.append(("enter", name))
            with super().phase(name):
                yield
            events.append(("exit", name))

    def save(path, feats, labels):
        events.append(("write", path))
        assert feats.shape == (sum(SIZES), 5 if path != "e" else
                               TINY.embed_dim)

    monkeypatch.setattr(extraction, "PhaseTimer", Watched)
    monkeypatch.setattr(extraction, "save_feature_cache", save)
    with timer.active():
        extraction.extract_to_caches(
            model, _batches(), [(None, "e"), (30.0, "a"), (10.0, "b")],
            _text(), write=True)
    assert [e for e in events if e[1] in ("e", "a", "b",
                                          "extract.softmax")] == [
        ("enter", "extract.softmax"), ("exit", "extract.softmax"),
        ("write", "e"),
        ("enter", "extract.softmax"), ("exit", "extract.softmax"),
        ("write", "a"),
        ("enter", "extract.softmax"), ("exit", "extract.softmax"),
        ("write", "b")]
    assert timer.counts["extract.softmax"] == 3
