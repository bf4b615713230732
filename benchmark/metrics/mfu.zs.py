"""The least time the card could take on the window's batches (harness/work.task_batch_bound_s) over the window (%)."""

from harness.readers import task_mfu as read  # noqa: F401
