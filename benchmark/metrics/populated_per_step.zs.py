"""Populated clusters a compact EM step solved, on average over the
window (clusters/step): the port's counter ``em.populated`` (each step's
batch-wide largest populated-cluster count, up to the compact width of
n_query + 16) over ``em.compact_steps`` (``methods/zero_shot/
em_dirichlet._em_step_compact``). Hard assignments hold it at most at
n_query. A program without the counters, or a window with no compact
step, leaves the metric out."""


def read(rec):
    phases = rec.get("phases") or {}
    if not phases.get("em.compact_steps") or "em.populated" not in phases:
        return None
    return phases["em.populated"] / phases["em.compact_steps"]
