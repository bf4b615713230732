"""The mean row width of a Newton-Minka step over the window (rows/step):
the port's counter ``newton.row_steps`` (each solve's steps times its
cluster rows a task) over ``newton.steps`` (core/profiling.py). 1,000 at
the full width of the ImageNet protocol, at most 91 compact, 32 on the
fast tier."""


def read(rec):
    phases = rec.get("phases") or {}
    if "newton.row_steps" not in phases or not phases.get("newton.steps"):
        return None
    return phases["newton.row_steps"] / phases["newton.steps"]
