"""Wall clock of the window per task completed in it (ms/task)."""

from harness.readers import per_task_ms as read  # noqa: F401
