"""The card's idle time a batch while the evaluator uploaded its feature
table (ms/batch): the evaluator's phase ``upload`` (once an evaluation,
before its first batch) as the innermost span over the traced batches'
idle stretches, scaled to the same batches untraced (harness/idle.py)."""

from harness.idle import TASK_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, TASK_SPANS, ("upload",), rec.get("trace_batches"))
