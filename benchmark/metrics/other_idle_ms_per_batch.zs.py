"""The card's idle time a batch that none of ``newton``, ``em.step``,
``host_wait``, ``upload`` and ``class_pools`` holds (ms/batch): the
evaluator's ``sampling``, ``dispatch``, ``method`` and ``deferred_fetch``
outside the spans under them, and the stretches with no span open, over
the traced batches, scaled to the same batches untraced
(harness/idle.py). With the five other zs idle readings it sums to the
batch's untraced idle time."""

from harness.idle import TASK_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, TASK_SPANS, None, rec.get("trace_batches"))
