"""The host's own time over the window, per batch (ms/batch): the window's
wall clock less the port's span ``host_wait`` (core/profiling.py: every
ops.common.to_host and device_sync, the host blocked on the card and the
copy), so issuing launches, sampling and the Python between them."""


def read(rec):
    phases = rec.get("phases") or {}
    if ("host_wait" not in phases or not rec.get("window_s")
            or not rec.get("batches")):
        return None
    return 1e3 * (rec["window_s"] - phases["host_wait"]) / rec["batches"]
