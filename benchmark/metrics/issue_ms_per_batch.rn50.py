"""The host's own issue time of a batch's towers (ms/batch): the port's
span ``extract.first_issue`` (eval/extraction.py: the host issuing a
pass's first batch, with nothing of the pass queued ahead of it, so that
no launch waits on the card), summed over the window's passes, over the
passes. The span over the whole loop (``extract.encode``) reads the card's
pace instead: past the first few batches the launch queue is full and the
host waits in it."""


def read(rec):
    phases = rec.get("phases") or {}
    if "extract.first_issue" not in phases or not rec.get("passes"):
        return None
    return 1e3 * phases["extract.first_issue"] / rec["passes"]
