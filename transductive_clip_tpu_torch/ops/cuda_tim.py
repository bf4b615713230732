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
every operand fp32; 'default' rounds x, W and G to bf16 as the TPU kernel
does (``pallas_tim.py:104,132-133,165-166``), with fp32 products and sums and
fp32 norms of the unrounded weights.

The wrapper takes its plain torch version — the same equations and
roundings — for tensors on the CPU, and only then; for CUDA tensors it
launches the kernel or raises. ``tim_support_grad.launches`` counts the
launches (one a call; the call enqueues the kernel's three passes).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import kernel_build
from .common import TIM_EPS, get_one_hot

SOURCE = "tim_support_grad.cu"
LOG_TIM_EPS = math.log(TIM_EPS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernel_build.load(SOURCE)
    lib.tclip_tim_support_grad.argtypes = [_P] * 9 + [_I] * 4 + [_F] * 3 + [
        _I, _I, _P]
    lib.tclip_tim_support_grad.restype = _I
    lib.tclip_error_string.argtypes = [_I]
    lib.tclip_error_string.restype = ctypes.c_char_p
    return lib


def _x_dtype(precision: str):
    return torch.float32 if precision == "highest" else torch.bfloat16


def prepare_support(support, y_s, precision: str = "default"):
    """One-time layout of the loop-invariant support, outside the Adam loop
    (the counterpart of ``pallas_tim.prepare_support``): x_p [N, s, d] in
    bf16 for 'default' and fp32 for 'highest', y_p [N, s] int32, both
    contiguous. The kernel masks its ragged edges, so nothing is padded and
    no ones column is planted: it sums G for ``col`` directly."""
    x_p = support.to(_x_dtype(precision)).contiguous()
    y_p = y_s.to(torch.int32).contiguous()
    return x_p, y_p


def _check_inputs(x_p, y_p, weights, n_support, d, ce_kind, precision):
    name = "tim_support_grad"
    for t, what in ((x_p, "x_p"), (y_p, "y_p"), (weights, "weights")):
        if t.device.type != "cuda" or t.device != x_p.device:
            raise ValueError(f"{name}: {what} is on {t.device}; every input "
                             "must be on one CUDA device (or all on the CPU "
                             "for the plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if x_p.dtype != _x_dtype(precision):
        raise TypeError(f"{name}: x_p must be {_x_dtype(precision)} for "
                        f"precision {precision!r}, got {x_p.dtype} "
                        "(use prepare_support)")
    if y_p.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"{name}: y_p must be int32 and weights float32, got "
                        f"{y_p.dtype} and {weights.dtype}")
    n, s, dx = x_p.shape
    if (y_p.shape != (n, s) or weights.dim() != 3 or weights.shape[0] != n
            or weights.shape[2] != dx):
        raise ValueError(f"{name}: shapes x_p {tuple(x_p.shape)}, y_p "
                         f"{tuple(y_p.shape)}, weights {tuple(weights.shape)} "
                         "do not fit [N, s, d], [N, s], [N, K, d]")
    if (s, dx) != (n_support, d):
        raise ValueError(f"{name}: x_p is [N, {s}, {dx}] but n_support={n_support}, "
                         f"d={d} (prepare_support pads nothing)")
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
    n, s, _ = x_p.shape
    k = weights.shape[1]
    dev = x_p.device
    gs_x = torch.empty((n, k, d), dtype=torch.float32, device=dev)
    col = torch.empty((n, k), dtype=torch.float32, device=dev)
    # scratch: the support logits, per-row lse and coefficient, 0.5 ||w||^2
    logits = torch.empty((n, s, k), dtype=torch.float32, device=dev)
    lse = torch.empty((n, s), dtype=torch.float32, device=dev)
    coef = torch.empty((n, s), dtype=torch.float32, device=dev)
    w2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tclip_tim_support_grad(
            x_p.data_ptr(), y_p.data_ptr(), weights.data_ptr(),
            gs_x.data_ptr(), col.data_ptr(), logits.data_ptr(),
            lse.data_ptr(), coef.data_ptr(), w2.data_ptr(), n, s, k, d,
            float(temp), float(scale), float(alpha_value),
            int(ce_kind != "Shannon"), int(precision != "highest"), stream)
    if rc != 0:
        msg = lib.tclip_error_string(rc).decode()
        raise RuntimeError(f"tim_support_grad: kernel launch failed: {msg} "
                           f"(cuda error {rc})")
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
