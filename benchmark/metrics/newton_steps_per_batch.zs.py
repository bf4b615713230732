"""Newton-Minka steps the window's batches ran, per batch (steps/batch):
the port's counter ``newton.steps`` (core/profiling.py, one count a solve
of ops/dirichlet.minka_newton_update_alpha, steps run past its stop
included), summed over the evaluator's PhaseTimer of every window
evaluation."""


def read(rec):
    phases = rec.get("phases") or {}
    if "newton.steps" not in phases or not rec.get("batches"):
        return None
    return phases["newton.steps"] / rec["batches"]
