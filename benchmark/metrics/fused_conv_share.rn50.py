"""Share of the image tower's convolutions that ran with their bias, ReLU
and residual add in cuDNN's fused epilogue (%): the port's counters
``resnet.fused_convs`` over ``resnet.convs`` (models/clip/resnet.py, once
a forward), summed over the window's passes. A program without them
leaves the metric out."""


def read(rec):
    phases = rec.get("phases") or {}
    if not phases.get("resnet.convs") or "resnet.fused_convs" not in phases:
        return None
    return 100.0 * phases["resnet.fused_convs"] / phases["resnet.convs"]
