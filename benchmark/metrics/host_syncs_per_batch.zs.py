"""ops.common.to_host.syncs over the window, per batch (syncs/batch)."""

from harness.readers import host_syncs_per_batch as read  # noqa: F401
