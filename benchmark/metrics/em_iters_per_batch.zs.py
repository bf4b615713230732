"""EM iterations the window's batches ran, per batch (iterations/batch):
the port's counter ``em.iterations`` (core/profiling.py), one count a solve
(the compact_first guard's exact re-solve too), summed over the
evaluator's PhaseTimer of every window evaluation."""


def read(rec):
    phases = rec.get("phases") or {}
    if "em.iterations" not in phases or not rec.get("batches"):
        return None
    return phases["em.iterations"] / rec["batches"]
