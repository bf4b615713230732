"""The alpha-TIM support-side cross-entropy gradient on the card
(counterpart of transductive_clip_tpu/ops/pallas_tim.py).

K3 ``tim_support_grad`` is CUDA C++ for sm_90a (``csrc/tim_support_grad.cu``),
the TPU kernel ``_support_grad_kernel`` behind ``tim_grad_impl: pallas``.
For every task it returns

    gs_x [N, K, d] = G^T x,   col [N, K] = sum_n G[n, :],
    G = scale * coef_n * (softmax_k(temp * (x_n . w_k - ||w_k||^2 / 2)) - onehot(y_n))

with the epsilon-capped Shannon or alpha coefficient of
``methods/few_shot/tim._ce_grad_coef``; the caller forms
``temp * (gs_x - col[..., None] * weights)``. Precision 'highest' keeps
every operand fp32 (FFMA; TF32 stays off); 'default' rounds x, W and G to
bf16 as the TPU kernel does (``pallas_tim.py:104,132-133,165-166``) and runs
both products on the tensor cores, with fp32 sums and fp32 norms of the
unrounded weights.

The wrapper takes its plain torch version — the same equations and
roundings — for tensors on the CPU, and only then; for CUDA tensors it
launches the kernel or raises. ``tim_support_grad.launches`` counts the
launches (one a call; the call enqueues the kernel's four passes).
:func:`tim_support_grad_tiled_reference` repeats the kernel's own order of
operations in torch ops (the padded layout, W and G rounded once, the
contractions slice by slice), for the CPU tests.
"""

from __future__ import annotations

import math

import torch

from . import kernel_build
from .common import TIM_EPS, get_one_hot

SOURCE = "tim_support_grad.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_tim_support_grad": "ppppppppp iiiiii fff ii p"}
LOG_TIM_EPS = math.log(TIM_EPS)

#: csrc constants: a block's output tile, the slices of the ring, and their
#: depth and row pitches in bf16 and fp32 (tests hold them against the source)
TILE, STAGES = 128, 3
DEPTH = {"default": 64, "highest": 16}
PITCH_K = {"default": 72, "highest": 20}      # [128][pitch], first product
PITCH_M = {"default": 136, "highest": 132}    # [depth][pitch], second product
#: K is padded to this many columns in the logits and G scratch
K_UNIT = 8


def _x_dtype(precision: str):
    return torch.float32 if precision == "highest" else torch.bfloat16


def _round_up(n: int, unit: int) -> int:
    return -(-n // unit) * unit


def padded_width(d: int, precision: str) -> int:
    """d rounded up so that a row of x starts on 16 bytes (8 bf16 values in
    'default', 4 fp32 in 'highest'): what the kernel's 16-byte copies need."""
    return _round_up(d, 4 if precision == "highest" else 8)


def smem_bytes(precision: str) -> tuple:
    """Shared memory of a block of the first and of the second product:
    the ring's slices of both operands."""
    item = 4 if precision == "highest" else 2
    return (item * STAGES * 2 * TILE * PITCH_K[precision],
            item * STAGES * 2 * DEPTH[precision] * PITCH_M[precision])


def prepare_support(support, y_s, precision: str = "default"):
    """One-time layout of the loop-invariant support, outside the Adam loop
    (the counterpart of ``pallas_tim.prepare_support``): x_p [N, s, dp] in
    bf16 for 'default' and fp32 for 'highest', y_p [N, s] int32, both
    contiguous. dp is :func:`padded_width` of d, the new columns zero; at
    the protocol's d = 1000 nothing is padded and only the cast is made.
    The kernel masks the support rows and the classes itself, and no ones
    column is planted: it sums G for ``col`` directly."""
    d = support.shape[-1]
    x_p = support.to(_x_dtype(precision))
    pad = padded_width(d, precision) - d
    if pad:
        x_p = torch.nn.functional.pad(x_p, (0, pad))
    y_p = y_s.to(torch.int32).contiguous()
    return x_p.contiguous(), y_p


def _check_inputs(x_p, y_p, weights, n_support, d, ce_kind, precision):
    name = "tim_support_grad"
    for t, what in ((x_p, "x_p"), (y_p, "y_p"), (weights, "weights")):
        if t.device.type != "cuda" or t.device != x_p.device:
            raise ValueError(f"{name}: {what} is on {t.device}; every input "
                             "must be on one CUDA device (or all on the CPU "
                             "for the plain version)")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and start "
                             "on 16 bytes")
    if x_p.dtype != _x_dtype(precision):
        raise TypeError(f"{name}: x_p must be {_x_dtype(precision)} for "
                        f"precision {precision!r}, got {x_p.dtype} "
                        "(use prepare_support)")
    if y_p.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"{name}: y_p must be int32 and weights float32, got "
                        f"{y_p.dtype} and {weights.dtype}")
    n, s, dx = x_p.shape
    if (y_p.shape != (n, s) or weights.dim() != 3 or weights.shape[0] != n
            or weights.shape[2] != d):
        raise ValueError(f"{name}: shapes x_p {tuple(x_p.shape)}, y_p "
                         f"{tuple(y_p.shape)}, weights {tuple(weights.shape)} "
                         "do not fit [N, s, dp], [N, s], [N, K, d]")
    if (s, dx) != (n_support, padded_width(d, precision)):
        raise ValueError(f"{name}: x_p is [N, {s}, {dx}] but n_support="
                         f"{n_support}, d={d} (prepare_support pads d to "
                         f"{padded_width(d, precision)})")
    if not 0 < n <= 65535:
        raise ValueError(f"{name}: N={n} outside 1..65535")
    if ce_kind not in ("Shannon", "Alpha"):
        raise ValueError(f"{name}: unknown ce_kind {ce_kind!r}")


def tim_support_grad(x_p, y_p, weights, temp, scale, alpha_value,
                     n_support: int, d: int, ce_kind: str = "Shannon",
                     precision: str = "default"):
    """K3 (see the module docstring) on ``prepare_support``'s layout.
    weights [N, K, d] fp32; temp, scale, alpha_value host numbers. Returns
    (gs_x [N, K, d], col [N, K]), fp32."""
    if (x_p.device.type == "cpu" and y_p.device.type == "cpu"
            and weights.device.type == "cpu"):
        return tim_support_grad_reference(
            x_p, y_p, weights, temp, scale, alpha_value, n_support, d,
            ce_kind=ce_kind, precision=precision)
    _check_inputs(x_p, y_p, weights, n_support, d, ce_kind, precision)
    n, s, dp = x_p.shape
    k = weights.shape[1]
    kp = _round_up(k, K_UNIT)
    dev = x_p.device
    bf16 = precision != "highest"
    gs_x = torch.empty((n, k, d), dtype=torch.float32, device=dev)
    col = torch.empty((n, k), dtype=torch.float32, device=dev)
    # scratch: the support logits (in 'highest' G overwrites them), 0.5
    # ||w||^2, and in 'default' G and the weights rounded to bf16; in
    # 'highest' a copy of the weights at x's row pitch when d is ragged
    logits = torch.empty((n, s, kp), dtype=torch.float32, device=dev)
    w2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    g_bf16 = w_prep = None
    if bf16:
        g_bf16 = torch.empty((n, s, kp), dtype=torch.bfloat16, device=dev)
    if bf16 or dp != d:
        w_prep = torch.empty((n, k, dp), dtype=x_p.dtype, device=dev)
    kernel_build.launch(
        kernel_build.load(SOURCE, SIGNATURES).tclip_tim_support_grad, dev,
        x_p.data_ptr(), y_p.data_ptr(), weights.data_ptr(), gs_x.data_ptr(),
        col.data_ptr(), logits.data_ptr(),
        None if g_bf16 is None else g_bf16.data_ptr(),
        None if w_prep is None else w_prep.data_ptr(), w2.data_ptr(),
        n, s, k, d, dp, kp, float(temp), float(scale), float(alpha_value),
        int(ce_kind != "Shannon"), int(bf16))
    tim_support_grad.launches += 1
    return gs_x, col


tim_support_grad.launches = 0


def tim_support_grad_reference(x_p, y_p, weights, temp, scale, alpha_value,
                               n_support: int, d: int,
                               ce_kind: str = "Shannon",
                               precision: str = "default"):
    """Plain torch version of K3: the same equations, masks and bf16
    roundings, in fp32 products (TF32 off)."""
    x = x_p[:, :n_support, :d].float()
    y = y_p[:, :n_support].long()
    w = weights.float()
    w2 = 0.5 * (w * w).sum(-1)                       # fp32, unrounded weights
    if precision != "highest":
        w = w.to(torch.bfloat16).float()
    logits = temp * (torch.einsum("tnd,tkd->tnk", x, w) - w2[:, None, :])
    onehot = get_one_hot(y, w.shape[1])
    lse = torch.logsumexp(logits, dim=-1)
    l_lab = torch.where(onehot > 0, logits, 0.0).sum(-1)
    z = l_lab - lse                                   # log p_label
    log_p = torch.logaddexp(z, torch.full_like(z, LOG_TIM_EPS))
    sigma = torch.exp(z - log_p)
    if ce_kind == "Shannon":
        coef = sigma
    else:
        coef = -torch.exp((1.0 - alpha_value) * log_p) * sigma
    g = (scale * coef)[..., None] * (torch.exp(logits - lse[..., None]) - onehot)
    if precision != "highest":
        g = g.to(torch.bfloat16).float()
    return torch.einsum("tnk,tnd->tkd", g, x), g.sum(1)


def tim_support_grad_tiled_reference(x_p, y_p, weights, temp, scale,
                                     alpha_value, n_support: int, d: int,
                                     ce_kind: str = "Shannon",
                                     precision: str = "default"):
    """K3 in the kernel's own order of operations, in torch ops on
    ``prepare_support``'s padded layout: the norms of the unrounded weights;
    W rounded once and laid at x's row pitch; the first product summed slice
    by slice over d (``DEPTH`` columns a slice, the last one zero-filled);
    one sweep a row for max, sum of exp, the label's logit and the
    coefficient; G rounded once into a scratch of ``K_UNIT``-padded width;
    the second product and ``col`` summed slice by slice over the support
    rows. The tiles a block owns do not change the arithmetic, only the
    slices do, so the tiles are not walked one by one."""
    n, s, dp = x_p.shape
    if (s, dp) != (n_support, padded_width(d, precision)):
        raise ValueError(f"x_p [N, {s}, {dp}] is not prepare_support's "
                         f"layout for n_support={n_support}, d={d}")
    bf16 = precision != "highest"
    depth = DEPTH[precision]
    k = weights.shape[1]
    kp = _round_up(k, K_UNIT)
    w = weights.float()
    w2 = 0.5 * (w * w).sum(-1)
    w_prep = torch.nn.functional.pad(w, (0, dp - d))
    if bf16:
        w_prep = w_prep.to(torch.bfloat16)
    x = x_p.float()
    w_prep = w_prep.float()
    xw = torch.zeros((n, s, k), dtype=torch.float32)
    for d0 in range(0, dp, depth):
        xw += torch.einsum("tnd,tkd->tnk", x[..., d0:d0 + depth],
                           w_prep[..., d0:d0 + depth])
    logits = temp * (xw - w2[:, None, :])
    y = y_p.long()
    live = (y >= 0) & (y < k)
    l_lab = torch.where(
        live, logits.gather(2, y.clamp(0, k - 1)[..., None])[..., 0], 0.0)
    m = logits.max(-1).values
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
    z = l_lab - lse
    log_p = torch.logaddexp(z, torch.full_like(z, LOG_TIM_EPS))
    sigma = torch.exp(z - log_p)
    coef = scale * (sigma if ce_kind == "Shannon"
                    else -torch.exp((1.0 - alpha_value) * log_p) * sigma)
    onehot = (torch.arange(k)[None, None, :] == y[..., None]).float()
    g = torch.zeros((n, s, kp), dtype=torch.float32)
    g[..., :k] = coef[..., None] * (torch.exp(logits - lse[..., None]) - onehot)
    if bf16:
        g = g.to(torch.bfloat16).float()
    gs_x = torch.zeros((n, kp, dp), dtype=torch.float32)
    col = torch.zeros((n, kp), dtype=torch.float32)
    for n0 in range(0, s, depth):
        gs_x += torch.einsum("tnk,tnd->tkd", g[:, n0:n0 + depth],
                             x[:, n0:n0 + depth])
        col += g[:, n0:n0 + depth].sum(1)
    return gs_x[:, :k, :d].contiguous(), col[:, :k].contiguous()
