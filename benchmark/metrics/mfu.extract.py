"""The image tower's products (harness/work.vit_image_flops) for the window's images at the bf16 peak, over the window (%)."""

from harness.work import PEAK_FLOPS_BF16


def read(rec):
    if not rec.get("images"):
        return None
    return (100.0 * rec["images"] * rec["image_flops"]
            / rec["window_s"] / PEAK_FLOPS_BF16)
