"""The card's idle time a pass that neither the softmax nor the issue
spans hold (ms/pass): the fetch's ``host_wait``, the concatenation and
the cache writes outside any span, and the stretches with no span open,
over the traced pass, scaled to a pass untraced (harness/idle.py). With
the two other extraction idle readings it sums to a pass's untraced idle
time."""

from harness.idle import EXTRACT_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, EXTRACT_SPANS, None, 1)
