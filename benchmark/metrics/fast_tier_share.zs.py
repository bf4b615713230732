"""Share of the window's compact EM steps that solved on the 32-row fast
tier (%): the port's counters ``em.fast_steps`` over ``em.compact_steps``
(``methods/zero_shot/em_dirichlet._em_step_compact``, once a step, the
first iteration's step under ``compact_first`` and the guard's re-solve
too). A step takes the fast tier when every task of its batch has at most
32 populated clusters. A program without the counters, or a window with
no compact step, leaves the metric out."""


def read(rec):
    phases = rec.get("phases") or {}
    if not phases.get("em.compact_steps") or "em.fast_steps" not in phases:
        return None
    return 100.0 * phases["em.fast_steps"] / phases["em.compact_steps"]
