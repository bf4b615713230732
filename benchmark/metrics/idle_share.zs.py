"""1 - the device's busy time in the traced batches over the same batches untraced, just before (%)."""

from harness.readers import idle_share as read  # noqa: F401
