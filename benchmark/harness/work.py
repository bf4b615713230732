"""The work a step needs, counted from shapes alone, and the card's peaks.

Frozen here so that no change to the program can move a roofline: each
count is what the inputs need (every input byte read once, every output
byte written once, the products an algorithm of this kind must compute),
whatever an implementation reads again or recomputes."""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, the data sheet's dense rates at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_FP32 = 67e12
PEAK_FLOPS_BF16 = 989e12

F32 = 4
BF16 = 2
I32 = 4
I64 = 8


def auction_bytes(n_task, n_rows, n_cols):
    """One auction launch: the [n_task, n_rows, n_cols] fp32 values read
    once, the [n_task, n_rows] int32 assignment written once."""
    return n_task * n_rows * n_cols * F32 + n_task * n_rows * I32


def attention_bytes(b, n, width, dtype_bytes=BF16):
    """One fused attention launch on [b, n, 3 width]: q, k and v read once,
    the [b, n, width] output written once."""
    return b * n * 3 * width * dtype_bytes + b * n * width * dtype_bytes


def em_step_flops(n_task, n_query, n_class):
    """One E-step's products: the [n_task, n_query, n_class] log-features
    against the [n_task, n_class, n_class] Dirichlet parameters."""
    return 2 * n_task * n_query * n_class * n_class


def task_batch_bytes(n_task, n_query, n_class, n_support=0):
    """A batch's gathered feature rows read once (support and query) and
    its per-task outputs written once: the [n_task, n_query] int64
    predictions and the [n_task] fp32 accuracies."""
    rows = n_task * (n_query + n_support) * n_class * F32
    return rows + n_task * n_query * I64 + n_task * F32


def task_batch_bound_s(n_task, n_query, n_class, n_support=0):
    """The least time the card could take on one batch: the larger of its
    bytes at the peak bandwidth and one E-step at the fp32 peak."""
    return max(task_batch_bytes(n_task, n_query, n_class, n_support)
               / PEAK_BYTES_PER_S,
               em_step_flops(n_task, n_query, n_class) / PEAK_FLOPS_FP32)


def vit_image_flops(image_size, patch, width, layers, embed_dim):
    """The image tower's products for one image: the patch embedding, per
    layer the qkv, score, weighted-value, output and two MLP products
    (hidden 4 width), and the final projection of the class token."""
    g = image_size // patch
    n = g * g + 1
    patch_embed = 2 * g * g * (3 * patch * patch) * width
    per_layer = (2 * n * width * 3 * width        # qkv
                 + 2 * n * n * width              # q k^T over all heads
                 + 2 * n * n * width              # p v
                 + 2 * n * width * width          # out projection
                 + 2 * 2 * n * width * 4 * width)  # c_fc and c_proj
    return patch_embed + layers * per_layer + 2 * width * embed_dim
