"""The card's idle time a pass while the host normalised the fetched
embeddings and made the softmax features (ms/pass): the port's span
``extract.softmax`` (eval/extraction.py, fp32 on the host) as the
innermost span over the traced pass's idle stretches, scaled to a pass
untraced (harness/idle.py)."""

from harness.idle import EXTRACT_SPANS, idle_ms


def read(rec):
    return idle_ms(rec, EXTRACT_SPANS, ("extract.softmax",), 1)
