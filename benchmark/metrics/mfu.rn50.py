"""The image tower's products (``image_flops`` of reference/clip_rn50.py:
every convolution and the attention pool's products, from shapes) for the
window's images at the bf16 peak, over the window (%)."""

from harness.work import PEAK_FLOPS_BF16


def read(rec):
    if not rec.get("images") or not rec.get("image_flops"):
        return None
    return (100.0 * rec["images"] * rec["image_flops"]
            / rec["window_s"] / PEAK_FLOPS_BF16)
