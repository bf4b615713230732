"""The evaluator's "sampling" phase (PhaseTimer) over the window, per batch (ms/batch)."""

from harness.readers import sampling_ms_per_batch as read  # noqa: F401
