"""The card's idle time a batch while the host was inside a Newton-Minka
solve and in none of the spans under it (ms/batch): the port's span
``newton`` (ops/dirichlet.minka_newton_update_alpha) as the innermost span
over the traced batches' idle stretches, scaled to the same batches
untraced (harness/idle.py)."""

from harness.idle import TASK_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, TASK_SPANS, ("newton",), rec.get("trace_batches"))
