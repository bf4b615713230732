"""Plain CLIP ViT-L/14@336px in fp32: the reference that the ViT-L/14@336px
extraction cell holds the program's softmax features against.

The towers' equations, the control's rounding and the weights' layout are
those of ``clip_vit.py`` (OpenAI's VisionTransformer, Transformer and
ResidualAttentionBlock with QuickGELU, fp32 with TF32 off), loaded by name;
the images are ``clip_rn50.py``'s smooth random fields, so that two
images' rows differ as two photographs' do and the check can tell them
apart. What is this configuration's own: ``softmax`` in blocks that fit
its 577 tokens, and ``work_counts``, whose attention bound takes the larger
of K4b's bytes and its products (at n = 577 the two are within 2%).
Imports nothing of the program.
"""

from __future__ import annotations

import os

from harness import spec, work

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
vit = spec.load_reference("clip_vit", _HERE)
text_features = vit.text_features
image_features = vit.image_features
# the control: every product's operands in fp8 e4m3, as the ViT's
CONTROL = vit.CONTROL
images = spec.load_reference("clip_rn50", _HERE).images
layout = vit.layout

# images a block of the reference's image tower: at 577 tokens and 16 heads
# a block's fp32 scores are 1.4 GB
BLOCK = 64


def softmax(cfg, sd, tokens, images, quant=None, block=BLOCK):
    """The softmax features [b, n_class] of ``images`` [b, H, W, 3] uint8
    against the prompts ``tokens``, fp32 from the weights ``sd``, in blocks
    of ``block`` images."""
    return vit.softmax(cfg, sd, tokens, images, quant, block)


def attention_flops(b, n, width):
    """One fused attention launch's products on [b, n, 3 width]: q k^T and
    p v over every head, 2 b n^2 width each."""
    return 4 * b * n * n * width


def work_counts(cfg, batch_sizes):
    """{image_flops: the image tower's products an image, k4b_bound_s: the
    least time of the fused attention over a pass of batches of these sizes,
    each launch's the larger of its bytes at the peak bandwidth and its
    products at the bf16 peak, ``layers`` launches a batch}."""
    v = cfg["vision"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    width = v["width"]
    k4b = v["layers"] * sum(
        max(work.attention_bytes(b, n, width) / work.PEAK_BYTES_PER_S,
            attention_flops(b, n, width) / work.PEAK_FLOPS_BF16)
        for b in batch_sizes)
    return {"image_flops": work.vit_image_flops(
        v["image_size"], v["patch_size"], width, v["layers"],
        cfg["embed_dim"]), "k4b_bound_s": k4b}
