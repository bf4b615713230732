"""K4b's bytes bound (q, k, v read once, the output written once) over its device time in the traced pass (%)."""

from harness.trace import named


def read(rec):
    tr = rec.get("trace")
    if not tr or "k4b_bound_s" not in rec:
        return None
    secs, calls = named(tr, "attention_blocked_bf16")
    if calls == 0 or secs <= 0:
        return None
    return 100.0 * rec["k4b_bound_s"] / secs
