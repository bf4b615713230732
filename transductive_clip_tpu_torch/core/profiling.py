"""Observability: the port's one registry of spans and counters, and
torch.profiler integration (counterpart of
transductive_clip_tpu/core/profiling.py).

* ``PhaseTimer`` sums named wall-clock spans (``phase``) and counters
  (``add``) into ``totals`` by name, with the number of records of each in
  ``counts``; ``summary()`` prints spans in seconds and counters as counts.
  Both evaluators make one an evaluation and make it the process's sink
  (``active()``) around their set-up phases and their batch loop, so what
  the code under them records lands there and in their "phase timing" log
  line. A timer made active inside another's extent records into both.
* ``span(name)`` and ``count(name, n)`` record into the active timer from
  wherever the work happens (``ops.common.to_host``: ``host_wait``;
  ``ops.dirichlet.minka_newton_update_alpha``: ``newton``,
  ``newton.steps``, ``newton.kernel_steps`` (the steps that ran in
  ``csrc/newton_minka.cu``), ``newton.row_steps``; the EM-Dirichlet loops:
  ``em.step`` (one an iteration, its step and its criterion read, with
  ``newton`` and ``host_wait`` inside), ``em.iterations``, and the
  zero-shot compact steps ``em.compact_steps``, ``em.fast_steps``,
  ``em.populated``; ``parallel.task_parallel``: ``parallel.*``). With no
  timer active they do nothing (one global read). The evaluators record
  their own phases on their timer (``upload``: the feature tables to the
  device, and ``class_pools``: the sampler's rows of each class, once an
  evaluation each; ``sampling``, ``dispatch``, ``method``,
  ``deferred_fetch``).
* While a profiler records, every span and phase is also a
  ``torch.profiler.record_function`` range, so it shows in the same trace
  as the kernels, on its clock; otherwise no range is entered.
* ``trace_if_requested`` wraps a block in a ``torch.profiler`` trace when a
  profile directory is configured (``--opts profile_dir /tmp/prof``) and
  writes a Chrome trace there; it is a no-op otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

# the active PhaseTimer (PhaseTimer.active), None when none is
_sink = None
_OFF = contextlib.nullcontext()


def _annotation(name):
    """A ``record_function`` range named ``name`` while a profiler records,
    else None (entering one costs ~15 us even with no profiler)."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return torch.profiler.record_function(name)


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = set()
        # the timer that was active when this one was made active
        self._outer = None

    def _record(self, name, value, counter=False):
        timer = self
        while timer is not None:
            if counter:
                timer.counters.add(name)
            timer.totals[name] += value
            timer.counts[name] += 1
            timer = timer._outer

    @contextlib.contextmanager
    def phase(self, name: str):
        annotation = _annotation(name)
        t0 = time.perf_counter()
        try:
            if annotation is None:
                yield
            else:
                with annotation:
                    yield
        finally:
            self._record(name, time.perf_counter() - t0)

    def add(self, name: str, n=1):
        """Counter ``name`` += ``n``, summed into ``totals`` with the
        spans."""
        self._record(name, n, counter=True)

    @contextlib.contextmanager
    def active(self):
        """Make this timer the process's sink for ``span`` and ``count``
        (not re-entrant); the previous sink is restored on exit."""
        global _sink
        prev = _sink
        self._outer, _sink = prev, self
        try:
            yield self
        finally:
            self._outer, _sink = None, prev

    def summary(self) -> str:
        spans = [n for n in self.totals if n not in self.counters]
        parts = [f"{name}: {self.totals[name]:.3f}s over "
                 f"{self.counts[name]} calls"
                 for name in sorted(spans, key=self.totals.get, reverse=True)]
        parts += [f"{name}: {self.totals[name]:.0f} counted"
                  for name in sorted(self.counters)]
        return " | ".join(parts) if parts else "no phases recorded"


def span(name: str):
    """A wall-clock span ``name`` of the active timer (a no-op context
    without one)."""
    sink = _sink
    return _OFF if sink is None else sink.phase(name)


def count(name: str, n=1):
    """Counter ``name`` += ``n`` on the active timer (nothing without
    one)."""
    sink = _sink
    if sink is not None:
        sink.add(name, n)


@contextlib.contextmanager
def trace_if_requested(profile_dir):
    """torch.profiler trace of the block (CPU and, when present, CUDA
    activity), exported as ``<profile_dir>/trace.json``; no-op when
    ``profile_dir`` is falsy."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(profile_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(profile_dir), "trace.json"))
