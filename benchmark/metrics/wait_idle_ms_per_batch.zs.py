"""The card's idle time a batch while the host was in a read back from the
card (ms/batch): the port's span ``host_wait`` (ops/common.to_host and
device_sync: the wait, then the copy to the host) as the innermost span
over the traced batches' idle stretches, scaled to the same batches
untraced (harness/idle.py)."""

from harness.idle import TASK_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, TASK_SPANS, ("host_wait",),
                   rec.get("trace_batches"))
