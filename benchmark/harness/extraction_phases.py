"""Extraction cells with the program's phases: ``harness/extraction.run``
as it is, with three things put in for the run.

- The images of the configuration's reference (``images`` of
  benchmark/reference/<reference>.py), where it makes its own, in place of
  harness/clip_inputs.py's uniform noise.
- A check that also has to fail rows handed to the wrong image: each
  pass's sampled rows, moved by one image, are judged as well. A check
  that passes them cannot tell one image from another, and the run is then
  not correct.
- The spans and counters that the port's
  ``eval.extraction.extract_to_caches`` records in its own ``PhaseTimer``
  (``extract.encode``, ``extract.first_issue``, ``host_wait``,
  ``extract.softmax``, ``extract.batches``, ``extract.images``), summed
  over the window's passes into the record's ``phases``. The port's
  extraction module gets a recording subclass of ``PhaseTimer`` for the
  run, as ``harness/task_eval.py`` gives the evaluators one. The warm-up
  encodes batches without ``extract_to_caches`` and makes no timer; the
  traced pass comes after the window's passes, and its timer is left out.
  A program whose extraction makes no timer leaves ``phases`` empty, and
  the readers of its metrics find nothing.

``control(cell, seed, device)`` is benchmark/control.py's extraction
control on the same images: the reference in fp8 in the program's place,
judged by the cell's check.
"""

from __future__ import annotations

import contextlib

import numpy as np

from . import clip_inputs, extraction

_judge = extraction.judge


@contextlib.contextmanager
def _replaced(module, name, value):
    """``module.name`` is ``value`` inside the block (made if absent)."""
    saved = module.__dict__.get(name)
    setattr(module, name, value)
    try:
        yield
    finally:
        if saved is None:
            delattr(module, name)
        else:
            setattr(module, name, saved)


def _images(cell):
    return getattr(cell.reference(), "images", clip_inputs.images)


def judge_telling_images_apart(cfg, passes, ref):
    """(checks, verdict) of ``harness/extraction.judge``; the verdict is
    also false where the same check passes every pass's rows moved by one
    image."""
    checks, ok = _judge(cfg, passes, ref)
    swapped, blind = _judge(cfg, [np.roll(p, 1, axis=0) for p in passes],
                            ref)
    extraction._say(
        f"rows moved by one image: log_softmax_gap "
        f"{swapped['log_softmax_gap']['value']} "
        f"({'passes: the check cannot tell images apart' if blind else 'fails'})")
    return checks, ok and not blind


def run(cell, seed, seconds, want_trace, device="cuda:0"):
    from transductive_clip_tpu_torch.core.profiling import PhaseTimer
    from transductive_clip_tpu_torch.eval import extraction as program

    timers = []

    class RecordingTimer(PhaseTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    with _replaced(program, "PhaseTimer", RecordingTimer), \
            _replaced(clip_inputs, "images", _images(cell)), \
            _replaced(extraction, "judge", judge_telling_images_apart):
        record = extraction.run(cell, seed, seconds, want_trace, device)
    phases = {}
    for t in timers[:record["passes"]]:
        for k, v in t.totals.items():
            phases[k] = phases.get(k, 0.0) + v
    record["phases"] = phases
    return record


def control(cell, seed, device="cuda"):
    """(checks, verdict) of benchmark/control.py's extraction control on
    the cell's images."""
    import control as controls

    with _replaced(clip_inputs, "images", _images(cell)):
        return controls.extraction_control(cell, seed, device)
