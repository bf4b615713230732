"""Observability: phase timers and torch.profiler integration
(counterpart of transductive_clip_tpu/core/profiling.py).

* ``PhaseTimer`` collects named wall-clock phases (sampling, method) across
  an evaluation and reports a summary,
* ``trace_if_requested`` wraps a block in a ``torch.profiler`` trace when a
  profile directory is configured (``--opts profile_dir /tmp/prof``) and
  writes a Chrome trace there; it is a no-op otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        parts = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            parts.append(
                f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            )
        return " | ".join(parts) if parts else "no phases recorded"


@contextlib.contextmanager
def trace_if_requested(profile_dir):
    """torch.profiler trace of the block (CPU and, when present, CUDA
    activity), exported as ``<profile_dir>/trace.json``; no-op when
    ``profile_dir`` is falsy."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(profile_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(profile_dir), "trace.json"))
