"""What the metric readers of benchmark/metrics/ share: each reads one
quantity from a run's record, or None where the record has nothing for it.
A metric that several kinds of cell report under names of their own (one
per end-to-end metric it moves) has one reader file a name, each taking
its function from here."""

from __future__ import annotations


def per_task_ms(rec):
    """Wall clock of the window per task completed in it (ms/task)."""
    if not rec.get("tasks"):
        return None
    return 1e3 * rec["window_s"] / rec["tasks"]


def sampling_ms_per_batch(rec):
    """The evaluator's "sampling" phase (PhaseTimer) over the window, per
    batch (ms/batch)."""
    if "sampling" not in rec.get("phases", {}) or not rec.get("batches"):
        return None
    return 1e3 * rec["phases"]["sampling"] / rec["batches"]


def host_syncs_per_batch(rec):
    """ops.common.to_host.syncs over the window, per batch (syncs/batch)."""
    if "host_syncs" not in rec or not rec.get("batches"):
        return None
    return rec["host_syncs"] / rec["batches"]


def kernels_per_batch(rec):
    """Device kernel launches in the traced stretch, per batch
    (kernels/batch)."""
    tr = rec.get("trace")
    if not tr or not rec.get("trace_batches"):
        return None
    return tr["kernels"] / rec["trace_batches"]


def task_mfu(rec):
    """The least time the card could take on the window's batches
    (harness/work.task_batch_bound_s) over the window (%)."""
    if not rec.get("batches"):
        return None
    return 100.0 * rec["batches"] * rec["batch_bound_s"] / rec["window_s"]


def idle_share(rec):
    """1 - the device's busy time in the traced stretch of work (the union
    of its operations' intervals) over the time the same work takes
    untraced in the window (%): the profiler slows the host, not the
    device, so its own window would read the host's slowdown as idle."""
    tr = rec.get("trace")
    if not tr or not rec.get("untraced_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / rec["untraced_s"])
