"""Device kernel launches in the traced batches, per batch (kernels/batch)."""

from harness.readers import kernels_per_batch as read  # noqa: F401
