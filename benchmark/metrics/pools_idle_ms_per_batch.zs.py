"""The card's idle time a batch while the evaluator built its sampler's
class pools (ms/batch): the evaluator's phase ``class_pools`` (once an
evaluation, before its first batch: each class's rows of the label
array, found in numpy) as the innermost span over the traced batches'
idle stretches, scaled to the same batches untraced (harness/idle.py)."""

from harness.idle import TASK_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, TASK_SPANS, ("class_pools",),
                   rec.get("trace_batches"))
