"""1 - the device's busy time in the traced pass over a pass's untraced time in the window (%)."""

from harness.readers import idle_share as read  # noqa: F401
