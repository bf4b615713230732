"""Host wall time inside the Newton-Minka solves over the window, per
batch (ms/batch): the port's span ``newton`` (core/profiling.py, around
ops/dirichlet.minka_newton_update_alpha, its stop-flag reads included),
summed over the evaluator's PhaseTimer of every window evaluation."""


def read(rec):
    phases = rec.get("phases") or {}
    if "newton" not in phases or not rec.get("batches"):
        return None
    return 1e3 * phases["newton"] / rec["batches"]
