"""Share of the image tower's average pools of a window above 1 that ran
in the port's hand-written NHWC pool kernel (%): the counters
``resnet.kernel_pools`` over ``resnet.pools`` (models/clip/resnet.py, once
a forward), summed over the window's passes. A program without them
leaves the metric out."""


def read(rec):
    phases = rec.get("phases") or {}
    if not phases.get("resnet.pools") or "resnet.kernel_pools" not in phases:
        return None
    return 100.0 * phases["resnet.kernel_pools"] / phases["resnet.pools"]
