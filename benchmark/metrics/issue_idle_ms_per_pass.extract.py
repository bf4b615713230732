"""The card's idle time a pass while the host issued the towers' batches
(ms/pass): the port's spans ``extract.encode`` (the issuing loop) and
``extract.first_issue`` (its first batch) as the innermost span over the
traced pass's idle stretches, scaled to a pass untraced
(harness/idle.py)."""

from harness.idle import EXTRACT_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, EXTRACT_SPANS,
                   ("extract.encode", "extract.first_issue"), 1)
