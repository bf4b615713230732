"""The card's idle time a batch while the host was issuing an EM
iteration's own work outside its solve (ms/batch): the port's span
``em.step`` (one an EM iteration: row selection, sufficient statistics,
the logits-cache update, the E-step and the criterion) as the innermost
span over the traced batches' idle stretches, scaled to the same batches
untraced (harness/idle.py)."""

from harness.idle import TASK_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, TASK_SPANS, ("em.step",), rec.get("trace_batches"))
