"""The auction's bytes bound (values read once, assignment written once) over its device time in the traced batches (%)."""

from harness.trace import named


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    secs, calls = named(tr, "auction_kernel")
    if calls == 0 or secs <= 0:
        return None
    return 100.0 * calls * rec["auction_bound_s"] / secs
