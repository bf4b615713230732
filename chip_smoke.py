#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each timed on a line of its own; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, and the build of
   every kernel from ``transductive_clip_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together);
2. K1 and K2 against their plain torch versions on the card, at the main
   path's shapes [100, 91, 1000] and [100, 32, 1000], a ragged
   [3, 13, 150] and a full-width [8, 1000, 1000] (K2's width on the
   guard's exact first iteration; its last block is ragged): inputs built
   as the EM step builds them, max relative difference < 1e-3,
   stationarity residual < 5e-3 on live rows, frozen rows bit-equal;
3. K3 against its plain version at the 4-shot protocol's shape
   [100, 4000, 1000, 1000] in 'highest' and 'default', at a ragged
   [3, 13, 150, 97] with non-uniform labels, and untimed at the edges of its
   tiles (s = 127, 128, 129; K = 128 and 150; d = 97, 1000 and 1008; some
   labels outside [0, K); Shannon and alpha): max difference over the
   output's magnitude < 1e-5 ('highest') and < 1e-2 ('default');
   kernel and plain times (CUDA events, median of 5 after a warm-up) beside
   the least time the card could take, and each of the kernel's four passes'
   own time (torch.profiler);
4. the zero-shot main path through the port's CLI at the ImageNet protocol
   (100 tasks x 75 queries x K = 1000) on a synthetic softmax cache: soft
   EM-Dirichlet with ``dirichlet_solver pallas`` (three batches), hard with
   ``mm_pallas``, and the default configuration;
5. the few-shot main path through the CLI at the 4-shot ImageNet protocol
   (support 4 x 1000 rows, 75 queries, 100 tasks a batch) on synthetic
   train and test caches: alpha-TIM with ``tim_grad_impl pallas`` (two
   batches, K3 once per Adam step), the same batch with ``autodiff`` (the
   predictions and u compared), one batch with ``tim_matmul_precision
   default`` (K3's bf16 path), and few-shot EM-Dirichlet soft with
   ``pallas`` (K1) and hard with ``mm_pallas`` (K2), whose two full-width
   K2 launches ([100, 1000, 1000]: iteration 1 and the pure-support fixed
   point) are held against the plain version on their own inputs, as in
   phase 2; a torch.profiler breakdown of three steady alpha-TIM Adam steps
   with K3;
6. torch.profiler breakdowns of one steady batch of zero-shot soft
   EM-Dirichlet with ``pallas`` and with ``auto``;
7. K4a and K4b against their plain version (the TPU kernels' order of
   operations in torch ops) at the text towers' shapes ([1000, 77, 3 x 512]
   bf16 with the causal mask, [1000, 77, 3 x 768] fp32), at
   ViT-L/14@336px's [64, 577, 3 x 1024] in fp32 and bf16, at ViT-B/16's
   [256, 197, 3 x 768] bf16, and untimed at ragged shapes, K4a's tile
   edges (n = 80, 128) and n = 577 bf16, without a mask, with the causal
   one and with a general one that kills whole key tiles for some rows; K5
   against its plain version at the four RN50 identity shapes at batch 512
   in bf16, one fp32 case, and untimed at the edges of the bf16 kernel's
   tiles (W not a multiple of 8, Cm = 24 and 72, an image smaller than a
   strip, a last strip of one row); max difference over the output's magnitude
   under K4_LIMIT / K5_LIMIT; kernel, plain and (for K4)
   scaled_dot_product_attention times beside the bound (K4: 20 calls queued
   in each timed window, the time of a lone call beside);
8. CLIP extraction with RN50 (bf16, ``fused_resnet=True``: K5 on the 12
   identity blocks of every batch, K4a in the text tower) at full width on
   random weights written as an OpenAI checkpoint, over a EuroSAT-shaped
   test split (the CoOp split's 8100 images and 10 classes through the
   port's ``build_dataset``; uint8 224 x 224 pixels made on the card from
   the seed: the script decodes no image and needs no PIL) in batches of 512,
   to the T = 30 softmax cache; the zero-shot evaluator over that cache
   through the port's CLI; one batch's features held against the plain
   route (``fused_resnet`` off, attention 'xla'), and with them the outputs
   of the first and the last attention module of each transformer tower
   (forward hooks), under K4_LIMIT; one batch timed through the kernel
   route and through the model's own plain route (``fused_resnet`` off:
   cuDNN's bf16 convolutions); a torch.profiler breakdown of one steady
   batch;
9. ViT-L/14@336px under float32 (K4b in the 24 image layers, K4a in the
   text tower) over every 32nd image of that split (254 images, cut from
   8100), batches of 64, its features and its first and last attention
   modules' outputs held against the 'xla' route on one batch.

With random weights an accuracy only has to be finite and in [0, 1].

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# the ImageNet protocol (bench.py, SURVEY.md section 3)
N_CLASS, PER_CLASS, N_QUERY, N_TASK = 1000, 50, 75, 100
# the few-shot protocol's support: every class x 4 shots, drawn from a
# synthetic train split of 64 images a class (the real one has ~1300)
SHOTS, TRAIN_PER_CLASS = 4, 64
# Adam steps of the alpha-TIM runs, cut from the protocol's 1000
TIM_ITER, TIM_ITER_DEFAULT = 50, 10
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s,
# fp32 operations/s outside the tensor cores, bf16 tensor-core operations/s
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
# fp32 operations per live element and update, counted from
# csrc/special.cuh (divisions, logf, expf and sqrtf count one each): K1 is
# 3 Newton steps of 46 plus ~10 (row sum, init, criterion); K2 is
# digamma_pos 25 + lgamma_pos 27 + curvature, root and row sum 19
OPS_PER_UPDATE = {"dirichlet_row_solve": 148, "mm_row_solve": 71}
# solver tolerance: each version sums a block's num/den in its own order, so
# near tol a block can stop one check apart — 49 more MM updates in K2,
# each moving alpha by up to ~3e-6 relative there. The runs on the H100 show
# up to 3.6e-5, too close to 1e-4 to tighten the limit.
MAX_REL_DIFF = 1e-3
MAX_RESIDUAL = 5e-3
# K3: max |kernel - plain| over max |plain|, per output. fp32 operands
# differ only in the order of the sums; with bf16 operands a G value can
# round to the neighbouring bf16 value (2^-8 relative)
K3_LIMIT = {"highest": 1e-5, "default": 1e-2}
MIN_ACCURACY = 0.95
# the K3 and autodiff alpha-TIM runs of one batch, both fp32: the same
# predictions on at least this share of queries, u within this distance
# (the H100 runs read a max |delta u| of 1.6e-7 after 50 steps; the limit
# is ~60x that, well under what a wrong gradient would move)
MIN_AGREEMENT = 0.999
MAX_DELTA_U = 1e-5
# K4a / K4b and K5 vs their plain versions: max |kernel - plain| over
# max |plain|, by dtype. fp32 differs only in the order of the sums; in bf16
# a p, h1, h2 or output value can land on the neighbouring bf16 value
# (2^-8 relative) and carry into what follows. Runs on an H100 80GB HBM3
# at 700 W read at most 1.3e-6 (K4, fp32: the online softmax divides once
# at the end), 2.7e-3 (K4, bf16: the tensor cores sum a score in another
# order, so a p, and then an output, can land on the neighbouring bf16
# value), 8.1e-7 (K5, fp32) and 6.9e-3 (K5, bf16: values of ~200 move by
# one bf16 ulp, 1.0)
K4_LIMIT = {"float32": 1e-5, "bfloat16": 1e-2}
K5_LIMIT = {"float32": 1e-5, "bfloat16": 2e-2}
# one batch's L2-normalized features, kernel route vs plain route: max
# |difference| over max |feature|. RN50 bf16: the plain graph rounds the
# conv outputs in cuDNN's bf16 order and the text attention's scores in
# bf16, so the roundings drift apart (the first H100 80GB HBM3 runs read
# 5.5e-3 for the images, 1.2e-2 for the text); ViT-L/14@336px fp32: only
# the order of the sums differs
FEATURE_LIMIT = {"RN50": 5e-2, "ViT-L/14@336px": 1e-4}
# the extraction slice: EuroSAT as the CoOp split has it (8100 test images,
# 10 classes), batches of extract_batch_size 512; ViT-L/14@336px on every
# 32nd test image in batches of 64
EUROSAT_CLASSES = (
    "Annual Crop Land", "Forest", "Herbaceous Vegetation Land",
    "Highway or Road", "Industrial Buildings", "Pasture Land",
    "Permanent Crop Land", "Residential Buildings", "River", "Sea or Lake")
EUROSAT_TEST = 8100
EXTRACT_BATCH = 512
VIT_EVERY, VIT_BATCH = 32, 64
# the synthetic BPE merges of tests/test_tokenizer.py (the real merges file
# is not in the repository)
BPE_MERGES = ("#version: 0.2", "c a", "ca t</w>", "d o", "do g</w>",
              "a t</w>")
# RN50's identity bottlenecks: ([H, W, C], Cm) and launches a batch
RN50_IDENTITY = (((56, 56, 256), 64, 2), ((28, 28, 512), 128, 3),
                 ((14, 14, 1024), 256, 5), ((7, 7, 2048), 512, 2))
# K3 at the edges of its 128 x 128 tiles, [N, s, K, d]: support rows around
# one tile, classes at one tile and past it, features whose rows do not
# start on 16 bytes (97), that end in half a slice (1000) or on one (1008)
K3_EDGES = ((2, 127, 128, 97), (2, 128, 150, 1000), (2, 129, 128, 1008),
            (2, 129, 150, 97))
# K5 at the edges of the bf16 kernel's tiles, [B, H, W, C, Cm]: W not a
# multiple of 8 with Cm = 24, rows off 16 bytes, an image smaller than a
# strip with Cm = 72, a last strip of one row (H = 5 in strips of 2) whose
# conv1 walks two chunks of rows, Cm = 72 at W = 9
K5_EDGES = ((3, 9, 11, 72, 24), (1, 5, 7, 30, 12), (3, 7, 7, 64, 72),
            (1, 5, 100, 16, 72), (1, 12, 9, 48, 72))


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name} seconds {time.perf_counter() - self.t0:.3f}")
        return False


def time_ms(fn, runs=5, inner=1):
    """Median milliseconds of ``fn`` on the card (CUDA events), after a
    warm-up call. ``inner`` calls are queued between the two events and the
    time divided by it: for a call of a fraction of a millisecond, whose
    host-side launch work would otherwise leave the card idle inside the
    window."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def solve_inputs(n_task, n_rows, k, seed, device="cuda"):
    """alpha0 = 1 and y built as the EM step builds it: weighted log-means of
    synthetic tasks (utils/synthetic.py) over each task's top-``n_rows``
    clusters by mass. Even tasks take the dense raw features (every row
    live, as iteration 1 compacted); odd tasks take hard assignments, whose
    empty rows carry the ROW_FREEZE sentinel except one left at the
    empty-cluster fill -10."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch.ops.common import EPS, get_one_hot, top_rows
    from transductive_clip_tpu_torch.ops.cuda_dirichlet import ROW_FREEZE
    from transductive_clip_tpu_torch.ops.dirichlet import weighted_log_means
    from transductive_clip_tpu_torch.utils.synthetic import make_zero_shot_tasks

    x, _ = make_zero_shot_tasks(np.random.default_rng(seed), n_task, N_QUERY, k)
    x = torch.as_tensor(x, device=device)
    lq = torch.log(x + EPS)
    _, cols = top_rows(x.sum(1), n_rows)
    u = torch.gather(x, 2, cols[:, None, :].expand(-1, N_QUERY, -1))
    hard = get_one_hot(torch.argmax(u, dim=-1), n_rows)
    odd = torch.arange(n_task, device=device)[:, None, None] % 2 == 1
    y, nonzero = weighted_log_means(torch.where(odd, hard, u), lq, eps=EPS)
    frozen = ~nonzero & odd
    frozen[1::2, n_rows - 1] = False   # one empty row (past k_eff <= 10) stays live
    y = torch.where(frozen, ROW_FREEZE, y).contiguous()
    return torch.ones_like(y), y


def check_kernel(name, wrapper, plain, a0, y, timing):
    """K1 or K2 vs its plain version on the card; returns the record
    fields."""
    import torch

    got = wrapper(a0, y)
    if got.is_cuda:
        torch.cuda.synchronize()
    return compare_solve(name, wrapper, plain, a0, y, got, timing)


def compare_solve(name, wrapper, plain, a0, y, got, timing, **kw):
    """Holds ``got``, the kernel's output on (a0, y), against the plain
    version on the same inputs (``kw`` passed to both); returns the record
    fields."""
    import torch

    from transductive_clip_tpu_torch.ops.cuda_dirichlet import ROW_FREEZE

    ref, iters = plain(a0, y, return_iters=True, **kw)
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    live = y[..., 0] < ROW_FREEZE / 2
    if not torch.equal(got[~live], a0[~live]):
        fail(f"{name}: a frozen row changed")
    diff = (got - ref).abs()
    rel = (diff / ref.abs().clamp_min(1e-6)).max().item()
    a = got[live].double()
    resid = (torch.digamma(a) - torch.digamma(a.sum(-1, keepdim=True))
             - y[live].double()).abs().max().item()
    shape = list(a0.shape)
    log(f"{name} {shape}: max_rel_diff {rel:.3e} max_abs_err "
        f"{diff.max().item():.3e} stationarity_residual {resid:.3e} "
        f"live_rows {int(live.sum())} plain_iters_max {int(iters.max())}")
    if not rel < MAX_REL_DIFF:
        fail(f"{name} {shape}: relative difference {rel} >= {MAX_REL_DIFF}")
    if not resid < MAX_RESIDUAL:
        fail(f"{name} {shape}: stationarity residual {resid} >= {MAX_RESIDUAL}")
    out = {"max_abs_err": diff.max().item()}
    if timing:
        from transductive_clip_tpu_torch.ops.cuda_dirichlet import block_rows_for

        n, r, k = shape
        bk = block_rows_for(r)
        live_pad = torch.nn.functional.pad(live, (0, -(-r // bk) * bk - r))
        live_per_block = live_pad.reshape(n, -1, bk).sum(-1)
        updates = int((iters * live_per_block).sum()) * k
        ops = updates * OPS_PER_UPDATE[name]
        nbytes = 3 * a0.numel() * 4
        t_ops, t_bytes = ops / PEAK_FP32_S * 1e3, nbytes / PEAK_BYTES_S * 1e3
        out.update(
            ms=time_ms(lambda: wrapper(a0, y)),
            plain_ms=time_ms(lambda: plain(a0, y)),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )
        log(f"{name} {shape}: ms {out['ms']:.4f} plain_ms "
            f"{out['plain_ms']:.4f} bound_ms {out['bound_ms']:.4f} "
            f"({out['bound_by']}: {ops:.4e} ops, {nbytes:.4e} bytes)")
    return out


def k3_inputs(n, s, k, d, seed, uniform, outside=False):
    """Support rows on the simplex peaked at their label (softmax features),
    labels — ``uniform``: s / k of each class, shuffled per task, as the
    sampler's support; else random and non-uniform — and weights at the
    support class means plus noise, as the Adam steps see them. With
    ``outside`` two labels of every task lie outside [0, K) (they match no
    class)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if uniform:
        base = torch.arange(k, device="cuda").repeat_interleave(s // k)
        order = torch.argsort(torch.rand(n, s, device="cuda", generator=g), 1)
        y = base[order]
    else:
        y = torch.randint(0, k, (n, s), device="cuda", generator=g)
        y[:, 0] = y[:, 1]
    logits = torch.randn(n, s, d, device="cuda", generator=g)
    logits.scatter_add_(2, (y % d)[..., None],
                        torch.full((n, s, 1), 4.0, device="cuda"))
    x = torch.softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(y, k).float()
    sums = torch.einsum("tsk,tsd->tkd", onehot, x)
    w = sums / onehot.sum(1).clamp_min(1.0)[..., None]
    w = (w + 1e-3 * torch.randn(n, k, d, device="cuda", generator=g)).contiguous()
    if outside:
        y[:, 2], y[:, 5] = -1, k + 3
    return x, y, w


def check_k3(shape, precision, kind, alpha, seed, uniform, timing,
             outside=False):
    """K3 vs its plain version on the card; returns the record fields."""
    import torch

    from transductive_clip_tpu_torch.ops import cuda_tim as ct

    n, s, k, d = shape
    x, y, w = k3_inputs(n, s, k, d, seed, uniform, outside)
    x_p, y_p = ct.prepare_support(x, y, precision)
    del x
    args = (x_p, y_p, w, 15.0, 1.0 / s, alpha, s, d)
    kw = dict(ce_kind=kind, precision=precision)
    gs, col = ct.tim_support_grad(*args, **kw)
    torch.cuda.synchronize()
    gs_r, col_r = ct.tim_support_grad_reference(*args, **kw)
    if not (torch.isfinite(gs).all() and torch.isfinite(col).all()):
        fail(f"tim_support_grad {shape} {precision}: non-finite output")
    rel_gs = ((gs - gs_r).abs().max() / gs_r.abs().max()).item()
    rel_col = ((col - col_r).abs().max() / col_r.abs().max()).item()
    err = max((gs - gs_r).abs().max().item(), (col - col_r).abs().max().item())
    log(f"tim_support_grad {shape} {precision} {kind}: rel_diff gs_x "
        f"{rel_gs:.3e} col {rel_col:.3e} (limit {K3_LIMIT[precision]:.0e}) "
        f"max_abs_err {err:.3e}")
    if not max(rel_gs, rel_col) < K3_LIMIT[precision]:
        fail(f"tim_support_grad {shape} {precision} {kind}: relative "
             f"difference {max(rel_gs, rel_col)} >= {K3_LIMIT[precision]}")
    del gs, col, gs_r, col_r
    out = {"max_abs_err": err}
    if timing:
        # two products of 2 N s K d operations; bytes: x, y, W read once,
        # gs_x and col written once
        ops = 2 * 2 * n * s * k * d
        nbytes = (x_p.numel() * x_p.element_size() + y_p.numel() * 4
                  + w.numel() * 4 + n * k * (d + 1) * 4)
        peak = PEAK_FP32_S if precision == "highest" else PEAK_BF16_S
        t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
        out.update(
            ms=time_ms(lambda: ct.tim_support_grad(*args, **kw)),
            plain_ms=time_ms(lambda: ct.tim_support_grad_reference(*args, **kw)),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
        )
        log(f"tim_support_grad {shape} {precision}: ms {out['ms']:.4f} "
            f"plain_ms {out['plain_ms']:.4f} bound_ms {out['bound_ms']:.4f} "
            f"({out['bound_by']}: {ops:.4e} ops, {nbytes:.4e} bytes)")
        out["passes_ms"] = k3_passes(
            lambda: ct.tim_support_grad(*args, **kw), shape, precision)
    torch.cuda.empty_cache()
    return out


def k3_passes(call, shape, precision, calls=3):
    """Each of K3's passes' own device time a call (torch.profiler over
    ``calls`` calls; the mean over the calls it kept), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    passes = {}
    for e in _device_events(prof):
        if "tclip::" in e.key:
            name = _pass_name(e.key)
            passes[name] = passes.get(name, 0.0) + _dev_us(e) / 1e3 / e.count
    if len(passes) != 4:
        fail(f"tim_support_grad {precision}: the profiler saw the passes "
             f"{sorted(passes)}, not four")
    log(f"tim_support_grad {shape} {precision} passes: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in passes.items()))
    return passes


def write_imagenet_cache(root, split, per_class, seed):
    """A synthetic ImageNet-shaped softmax cache: 1000 classes x
    ``per_class`` images, each drawn from a Dirichlet peaked at its class
    (concentration 60, as utils/synthetic.py draws them)."""
    import numpy as np

    from transductive_clip_tpu_torch.features.cache import (
        save_feature_cache,
        softmax_cache_path,
    )

    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(N_CLASS), per_class)
    conc = np.ones((labels.size, N_CLASS))
    conc[np.arange(labels.size), labels] += 60.0
    feats = rng.gamma(conc).astype(np.float32)
    feats /= feats.sum(-1, keepdims=True)
    save_feature_cache(softmax_cache_path("imagenet", split, "RN50", 30,
                                          root=root), feats, labels)


def run_main_path(root, label, opts, number_tasks, counters, on_batch=None):
    """The port's CLI entry, in process, with every kernel count set to 0
    just before; returns (accuracy, ms/task over the batches after the
    first, launches by kernel, host syncs per batch). Each batch is logged
    with its own counts; ``on_batch(method, logs)`` sees each batch."""
    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.methods.base import TransductiveMethod
    from transductive_clip_tpu_torch.ops.common import to_host

    opts = ["dataset", "imagenet", "number_tasks", str(number_tasks),
            "batch_size", str(N_TASK), "n_query", str(N_QUERY),
            "root", root, "save_results", "False",
            "log_path", os.path.join(root, "logs"), *opts]
    for wrapper in counters.values():
        wrapper.launches = 0
    to_host.syncs = 0
    run_task = TransductiveMethod.run_task

    def logged_run_task(self, task_dic, shot=None):
        """One batch of the evaluation, logged with its own counts."""
        before = [w.launches for w in counters.values()] + [to_host.syncs]
        logs = run_task(self, task_dic, shot)
        after = [w.launches for w in counters.values()] + [to_host.syncs]
        delta = [b - a for a, b in zip(before, after)]
        log(f"  batch: ms_per_task {1e3 * logs['timestamps']:.4f} "
            f"iterations {len(logs['timestamps_cumulative'])} accuracy "
            f"{logs['acc'].mean():.6f} launches "
            f"{dict(zip(counters, delta[:-1]))} host_syncs {delta[-1]}")
        if on_batch is not None:
            on_batch(self, logs)
        return logs

    TransductiveMethod.run_task = logged_run_task
    try:
        acc, sec_per_task = cli.main(
            ["--config-root", os.path.join(HERE, "config"), "--opts", *opts])
    finally:
        TransductiveMethod.run_task = run_task
    launches = {name: w.launches for name, w in counters.items()}
    n_batches = number_tasks // N_TASK
    syncs = to_host.syncs / n_batches
    log(f"main path {label}: accuracy {acc:.6f} ms_per_task "
        f"{1e3 * sec_per_task:.4f} batches {n_batches} launches {launches} "
        f"host_syncs_per_batch {syncs:.2f}")
    if not acc > MIN_ACCURACY:
        fail(f"{label}: accuracy {acc} <= {MIN_ACCURACY}")
    return acc, 1e3 * sec_per_task, launches, syncs


def _device_events(prof):
    """Device-side events only (kernels, copies, fills): the CPU ops that
    launched them carry the same time again."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.key != "Activity Buffer Request"]


def _pass_name(key):
    """A port kernel's own name out of a profiler key like
    ``void tclip::name<T>(args)``."""
    return key.split("tclip::")[1].split("(")[0].split("<")[0]


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _report_profile(label, prof, wall_us, syncs, top=10):
    events = _device_events(prof)
    busy = sum(_dev_us(e) for e in events)
    log(f"profile {label}: wall_ms {wall_us / 1e3:.3f} device_busy_ms "
        f"{busy / 1e3:.3f} busy_share {busy / wall_us:.4f} host_syncs {syncs}")
    if busy <= 0:
        log(f"profile {label}: the profiler recorded no device time")
    for e in sorted(events, key=_dev_us, reverse=True)[:top]:
        if _dev_us(e) > 0:
            log(f"profile {label}: {_dev_us(e) / 1e3:9.3f} ms "
                f"{e.count:6d} calls  {e.key[:90]}")
    return events, busy


def profile_batch(root, solver):
    """Where one steady-state batch of the zero-shot soft main path spends
    its time: the method's run_task on a second sampled batch (the first
    one hosts the compact_first guard and the warm-up) under torch.profiler;
    prints the top kernels by device time and the device's busy share of the
    wall clock."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transductive_clip_tpu_torch.core.config import load_full_config
    from transductive_clip_tpu_torch.features.cache import (
        load_feature_cache,
        softmax_cache_path,
    )
    from transductive_clip_tpu_torch.methods import get_zero_shot_method
    from transductive_clip_tpu_torch.ops.common import to_host
    from transductive_clip_tpu_torch.tasks import (
        CategoriesSamplerZeroShot,
        SamplerQueryZeroShot,
    )

    cfg = load_full_config(
        opts=["dataset", "imagenet", "method", "em_dirichlet", "shots", "0",
              "n_query", str(N_QUERY), "dirichlet_solver", solver],
        config_root=os.path.join(HERE, "config"))
    feats, labels = load_feature_cache(
        softmax_cache_path("imagenet", "test", "RN50", 30, root=root))
    sampler = CategoriesSamplerZeroShot(N_TASK, cfg.k_eff, cfg.n_class,
                                        N_QUERY, force_query_size=True,
                                        rng=np.random.default_rng(SEED))
    sampler.create_list_classes(labels)
    method = get_zero_shot_method(cfg.name_method, args=cfg)
    feats_dev = torch.as_tensor(feats, device="cuda")
    for b in range(2):
        idx = np.stack(list(SamplerQueryZeroShot(sampler)))
        # gathered on the card, as the evaluator's device_gather does
        task = {"x_q": feats_dev[torch.as_tensor(idx, device="cuda")],
                "y_q": labels[idx][..., None]}
        if b == 0:
            method.run_task(task)
            continue
        torch.cuda.synchronize()
        to_host.syncs = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            method.run_task(task)
            wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(f"zero-shot {solver}", prof, wall_us, to_host.syncs)


def profile_tim_steps(method, task, n_steps=3):
    """Where steady alpha-TIM Adam steps with K3 spend their device time:
    ``n_steps`` steps (the gradient, then optax's Adam update) of a
    main-path batch under torch.profiler, after a warm-up step, without
    TIM's one-time setup: K3's four passes, the query side's products
    (cuBLAS gemm kernels) and the rest (softmax and query gradient,
    elementwise); the Adam update timed alone with CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transductive_clip_tpu_torch.methods.few_shot import tim as ttim
    from transductive_clip_tpu_torch.methods.few_shot.paddle import (
        support_class_means,
    )

    args = method.args
    kw = method._tim_kwargs(task)
    support, query, y_s = task["x_s"], task["x_q"], task["y_s"]
    grad_fn = ttim._make_grad_fn(
        kw["grad_impl"], support, query, y_s,
        0.5 * (support * support).sum(-1), 0.5 * (query * query).sum(-1),
        float(args.temp), float(args.alpha_value),
        [float(v) for v in args.loss_weights], tuple(args.entropies),
        kw["n_class"], kw["precision"], kw["ce_impl"])
    lr, opt_dtype = float(args.lr_alpha_tim), kw["opt_dtype"]
    w = support_class_means(support, y_s, kw["n_class"])
    state = ttim._adam_init(w, opt_dtype)

    def step(w, state):
        _, grads = grad_fn(w)
        return ttim._adam_step(w, grads, state, lr, opt_dtype)

    w, state = step(w, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            w, state = step(w, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events, busy = _report_profile(f"alpha-TIM {n_steps} steps", prof,
                                   wall_us, 0, top=12)
    # K3's passes run once a step each: a pass's mean over the calls the
    # profiler kept (it can drop one) stands for its time a step
    k3_events = [e for e in events if "tclip::" in e.key]
    k3 = n_steps * sum(_dev_us(e) / e.count for e in k3_events)
    busy += k3 - sum(_dev_us(e) for e in k3_events)
    gemm = sum(_dev_us(e) for e in events
               if "gemm" in e.key.lower() or "cutlass" in e.key.lower())
    _, grads = grad_fn(w)
    adam_ms = time_ms(lambda: ttim._adam_step(w, grads, state, lr, opt_dtype))
    if busy > 0:
        log(f"profile alpha-TIM per step: K3 {k3 / 1e3 / n_steps:.3f} ms "
            f"(share {k3 / busy:.4f}; " + ", ".join(
                f"{_pass_name(e.key)} {_dev_us(e) / e.count / 1e3:.3f}"
                for e in k3_events)
            + f"), gemm {gemm / 1e3 / n_steps:.3f} ms "
            f"(share {gemm / busy:.4f}), other "
            f"{(busy - k3 - gemm) / 1e3 / n_steps:.3f} ms (share "
            f"{(busy - k3 - gemm) / busy:.4f}) of device busy; the Adam "
            f"update alone {adam_ms:.3f} ms")


def run_few_shot(root, counters, records, launches):
    """Phase 5: the few-shot paths through the CLI."""
    import torch

    from transductive_clip_tpu_torch.methods.few_shot import em_dirichlet as tem
    from transductive_clip_tpu_torch.methods.few_shot import tim as ttim
    from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd

    fs = ["shots", str(SHOTS)]
    seen = {}

    def keep_last(method, logs):
        seen["method"] = method

    infer = ttim.ALPHA_TIM._infer

    def kept_infer(self, task):
        out = infer(self, task)
        seen["task"], seen["u"] = task, out[0]
        return out

    with Phase("few_shot_alpha_tim_pallas"):
        ttim.ALPHA_TIM._infer = kept_infer
        try:
            _, _, got, _ = run_main_path(
                root, "alpha_tim tim_grad_impl=pallas",
                fs + ["method", "alpha_tim", "tim_grad_impl", "pallas",
                      "iter", str(TIM_ITER)],
                2 * N_TASK, counters, on_batch=keep_last)
        finally:
            ttim.ALPHA_TIM._infer = infer
        launches["tim_support_grad"] = got["tim_support_grad"]
        if got["tim_support_grad"] != 2 * TIM_ITER:
            fail(f"alpha-TIM launched tim_support_grad "
                 f"{got['tim_support_grad']} times, not once per Adam step "
                 f"({2 * TIM_ITER})")
    with Phase("few_shot_alpha_tim_autodiff"):
        method, task = seen["method"], seen["task"]
        args = method.args.clone()
        args.tim_grad_impl = "autodiff"
        u_ad, _ = ttim.ALPHA_TIM(args=args)._infer(task)
        u_k3 = seen["u"]
        agree = (u_ad.argmax(-1) == u_k3.argmax(-1)).float().mean().item()
        du = (u_ad - u_k3).abs().max().item()
        log(f"alpha-TIM K3 vs autodiff, one batch, {TIM_ITER} steps, "
            f"precision {method._tim_kwargs(task)['precision']}: prediction "
            f"agreement {agree:.6f} max_abs_delta_u {du:.3e} (alpha_value "
            f"{method.args.alpha_value})")
        if agree < MIN_AGREEMENT or not du < MAX_DELTA_U:
            fail(f"alpha-TIM K3 vs autodiff: agreement {agree}, max |du| {du}")
        del u_ad
    with Phase("profile_alpha_tim"):
        profile_tim_steps(method, task)
        del seen["task"], task
        torch.cuda.empty_cache()
    with Phase("few_shot_alpha_tim_default_precision"):
        _, _, got, _ = run_main_path(
            root, "alpha_tim tim_grad_impl=pallas precision=default",
            fs + ["method", "alpha_tim", "tim_grad_impl", "pallas",
                  "tim_matmul_precision", "default",
                  "iter", str(TIM_ITER_DEFAULT)],
            N_TASK, counters)
        if got["tim_support_grad"] != TIM_ITER_DEFAULT:
            fail("the bf16 alpha-TIM batch launched tim_support_grad "
                 f"{got['tim_support_grad']} times, not {TIM_ITER_DEFAULT}")
    with Phase("few_shot_em_dirichlet_pallas"):
        _, _, got, _ = run_main_path(
            root, "few-shot em_dirichlet solver=pallas",
            fs + ["method", "em_dirichlet", "dirichlet_solver", "pallas"],
            2 * N_TASK, counters)
        records["dirichlet_row_solve"]["few_shot_launches"] = (
            got["dirichlet_row_solve"])
        if got["dirichlet_row_solve"] <= 0:
            fail("few-shot soft EM launched dirichlet_row_solve 0 times")
    with Phase("few_shot_hard_em_dirichlet_mm_pallas"):
        # K2's full-width solves (iteration 1 and the pure-support fixed
        # point, [100, 1000, 1000], no row mask) keep copies of their inputs
        # and output, held against the plain version after the run
        update_alpha, full_width = tem.update_alpha, []

        def kept_update_alpha(alpha0, y_cst, iter_mm=1000, solver="mm",
                              row_mask=None):
            out = update_alpha(alpha0, y_cst, iter_mm=iter_mm, solver=solver,
                               row_mask=row_mask)
            if alpha0.shape[1] == N_CLASS:
                full_width.append((alpha0.clone(), y_cst.clone(), out.clone(),
                                   {"iter_mm": iter_mm}))
            return out

        tem.update_alpha = kept_update_alpha
        try:
            _, _, got, _ = run_main_path(
                root, "few-shot hard_em_dirichlet solver=mm_pallas",
                fs + ["method", "hard_em_dirichlet", "dirichlet_solver",
                      "mm_pallas"],
                N_TASK, counters)
        finally:
            tem.update_alpha = update_alpha
        records["mm_row_solve"]["few_shot_launches"] = got["mm_row_solve"]
        if got["mm_row_solve"] <= 0:
            fail("few-shot hard EM launched mm_row_solve 0 times")
    with Phase("few_shot_mm_row_solve_vs_plain"):
        if len(full_width) != 2:
            fail(f"few-shot hard EM made {len(full_width)} full-width "
                 "mm_row_solve launches, not 2 (iteration 1, alpha_base)")
        rec = records["mm_row_solve"]
        while full_width:
            a0, y, out, kw = full_width.pop(0)
            err = compare_solve("mm_row_solve", cd.mm_row_solve,
                                cd.mm_row_solve_reference, a0, y, out, False,
                                **kw)["max_abs_err"]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del a0, y, out
        torch.cuda.empty_cache()


def _bound(ops, nbytes, peak):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _rel_err(name, got, ref, limit):
    """(max |got - ref|, that over max |ref|); fails past ``limit`` or on a
    non-finite output."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    if not rel < limit:
        fail(f"{name}: relative difference {rel} >= {limit}")
    return err, rel


def check_attention(wrapper, b, n, width, heads, dtype, masked, seed,
                    timing):
    """K4a or K4b (``wrapper``) vs the plain version on a random qkv;
    ``masked``: False, True (the causal mask) or 'general'. With ``timing``,
    kernel, plain and scaled_dot_product_attention times beside the bound
    (4 b heads n^2 64 operations; qkv and out bytes)."""
    import torch
    import torch.nn.functional as F

    import numpy as np

    from transductive_clip_tpu_torch.ops import cuda_attention as ca
    from transductive_clip_tpu_torch.utils.synthetic import (
        make_general_attention_mask,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * width, generator=g, device="cuda").to(dtype)
    if masked == "general":
        mask = torch.as_tensor(make_general_attention_mask(
            np.random.default_rng(seed), n), device="cuda")
    else:
        mask = (torch.full((n, n), float("-inf"), dtype=dtype,
                           device="cuda").triu(1) if masked else None)
    got = wrapper(qkv, heads, mask)
    torch.cuda.synchronize()
    ref = ca.fused_attention_reference(qkv, heads, mask)
    name = f"{wrapper.__name__} [{b}, {n}, 3 x {width}] {str(dtype)[6:]}" + (
        {False: "", True: " causal"}.get(masked, f" {masked} mask"))
    err, rel = _rel_err(name, got, ref, K4_LIMIT[str(dtype)[6:]])
    log(f"{name}: rel_diff {rel:.3e} max_abs_err {err:.3e}")
    out = {"max_abs_err": err}
    if timing:
        q, k, v = (t.permute(0, 2, 1, 3) for t in
                   qkv.view(b, n, 3, heads, width // heads).unbind(2))

        def library():
            return F.scaled_dot_product_attention(q, k, v,
                                                  is_causal=bool(masked))

        lib_out = library().permute(0, 2, 1, 3).reshape(b, n, width)
        lib_rel = ((lib_out.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
        item = qkv.element_size()
        ops = 4 * b * heads * n * n * (width // heads)
        nbytes = qkv.numel() * item + b * n * width * item
        peak = PEAK_FP32_S if dtype == torch.float32 else PEAK_BF16_S
        # 20 calls in a window: these run for a fraction of a millisecond
        out.update(ms=time_ms(lambda: wrapper(qkv, heads, mask), inner=20),
                   ms_single_call=time_ms(lambda: wrapper(qkv, heads, mask)),
                   plain_ms=time_ms(lambda: ca.fused_attention_reference(
                       qkv, heads, mask), inner=20),
                   library_ms=time_ms(library, inner=20),
                   **_bound(ops, nbytes, peak))
        log(f"{name}: ms {out['ms']:.4f} (one call a window "
            f"{out['ms_single_call']:.4f}) plain_ms {out['plain_ms']:.4f} "
            f"library_ms {out['library_ms']:.4f} (sdpa rel_diff "
            f"{lib_rel:.3e}) bound_ms {out['bound_ms']:.4f} "
            f"({out['bound_by']}: {ops:.4e} ops, {nbytes:.4e} bytes)")
    del qkv, got, ref
    torch.cuda.empty_cache()
    return out


def check_bottleneck(b, h, w, c, c_mid, dtype, seed, timing):
    """K5 vs its plain version on random inputs in the kernel layout; with
    ``timing``, kernel and plain (cuDNN convolutions) times beside the
    bound (the three convolutions' operations; x, out and weight bytes)."""
    import torch

    from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb

    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, scale=0.1):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    args = (t(b, h, w, c, scale=1.0).to(dtype), t(c, c_mid).to(dtype),
            t(c_mid, scale=0.01), t(3, 3, c_mid, c_mid).to(dtype),
            t(c_mid, scale=0.01), t(c_mid, c).to(dtype),
            t(c, scale=0.01).to(dtype))
    got = cb.fused_identity_bottleneck(*args)
    torch.cuda.synchronize()
    ref = cb.fused_identity_bottleneck_reference(*args)
    name = (f"fused_identity_bottleneck [{b}, {h}, {w}, {c}] / {c_mid} "
            f"{str(dtype)[6:]}")
    err, rel = _rel_err(name, got, ref, K5_LIMIT[str(dtype)[6:]])
    log(f"{name}: rel_diff {rel:.3e} max_abs_err {err:.3e} strip_rows "
        f"{cb.strip_rows(h, w, c, c_mid, dtype)}")
    out = {"max_abs_err": err}
    if timing:
        ops = 2 * b * h * w * (2 * c * c_mid + 9 * c_mid * c_mid)
        nbytes = sum(a.numel() * a.element_size() for a in args) + (
            got.numel() * got.element_size())
        peak = PEAK_FP32_S if dtype == torch.float32 else PEAK_BF16_S
        out.update(ms=time_ms(lambda: cb.fused_identity_bottleneck(*args)),
                   plain_ms=time_ms(
                       lambda: cb.fused_identity_bottleneck_reference(*args)),
                   **_bound(ops, nbytes, peak))
        log(f"{name}: ms {out['ms']:.4f} plain_ms {out['plain_ms']:.4f} "
            f"bound_ms {out['bound_ms']:.4f} ({out['bound_by']}: "
            f"{ops:.4e} ops, {nbytes:.4e} bytes)")
    del args, got, ref
    torch.cuda.empty_cache()
    return out


def run_kernel_checks_clip(records):
    """Phases k4_vs_plain and k5_vs_plain."""
    import torch

    from transductive_clip_tpu_torch.ops import cuda_attention as ca
    from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb

    bf16, fp32 = torch.bfloat16, torch.float32
    with Phase("k4_vs_plain"):
        rows = check_attention(ca.attention_rows, 1000, 77, 512, 8, bf16,
                               True, 11, True)
        rows["fp32_text"] = check_attention(ca.attention_rows, 1000, 77, 768,
                                            12, fp32, True, 12, True)
        blocked = check_attention(ca.attention_blocked, 64, 577, 1024, 16,
                                  fp32, False, 13, True)
        # bf16 is the default clip_compute: the ViT towers' own shapes
        blocked["bf16_vitl336"] = check_attention(
            ca.attention_blocked, 64, 577, 1024, 16, bf16, False, 14, True)
        blocked["bf16_vitb16"] = check_attention(
            ca.attention_blocked, 256, 197, 768, 12, bf16, False, 15, True)
        # untimed: ragged shapes, masks, tile edges; K4a takes n <= 128
        cases = ((53, fp32, False), (53, bf16, True), (197, bf16, False),
                 (130, fp32, True), (577, bf16, False), (77, fp32, "general"),
                 (80, bf16, "general"), (128, fp32, True),
                 (197, fp32, "general"), (197, bf16, "general"))
        for wrapper, rec in ((ca.attention_rows, rows),
                             (ca.attention_blocked, blocked)):
            for n, dtype, masked in cases:
                if wrapper is ca.attention_rows and n > ca.ROWS_MAX_N:
                    continue
                err = check_attention(wrapper, 5, n, 320, 5, dtype, masked,
                                      n, False)["max_abs_err"]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
        for rec, keys in ((rows, ("fp32_text",)),
                          (blocked, ("bf16_vitl336", "bf16_vitb16"))):
            rec["max_abs_err"] = max([rec["max_abs_err"]]
                                     + [rec[k]["max_abs_err"] for k in keys])
        records["attention_rows"], records["attention_blocked"] = rows, blocked
    with Phase("k5_vs_plain"):
        # one record for a batch of 512 images: the sums over its 12
        # launches (2, 3, 5 and 2 at the four stages' shapes)
        rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "per_shape": []}
        ops_bound = 0.0
        for (h, w, c), c_mid, count in RN50_IDENTITY:
            one = check_bottleneck(EXTRACT_BATCH, h, w, c, c_mid, bf16, h,
                                   True)
            rec["max_abs_err"] = max(rec["max_abs_err"], one["max_abs_err"])
            for key in ("ms", "plain_ms", "bound_ms"):
                rec[key] += count * one[key]
            if one["bound_by"] == "operations":
                ops_bound += count * one["bound_ms"]
            rec["per_shape"].append({"shape": [EXTRACT_BATCH, h, w, c, c_mid],
                                     "launches_a_batch": count, **one})
        rec["bound_by"] = ("operations" if ops_bound >= rec["bound_ms"] / 2
                           else "bytes")
        rec["fp32"] = check_bottleneck(64, 14, 14, 1024, 256, fp32, 3, True)
        errs = [rec["max_abs_err"], rec["fp32"]["max_abs_err"]]
        for seed, shape in enumerate(K5_EDGES, start=4):
            for dtype in (bf16, fp32):
                # two rows of [100, 72] fp32 are over the fp32 kernel's budget
                if cb.fused_bottleneck_supported(*shape[1:], dtype):
                    errs.append(check_bottleneck(*shape, dtype, seed,
                                                 False)["max_abs_err"])
        rec["max_abs_err"] = max(errs)
        log(f"fused_identity_bottleneck, a batch of {EXTRACT_BATCH} (12 "
            f"launches): ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
            f"bound_ms {rec['bound_ms']:.4f}")
        records["fused_identity_bottleneck"] = rec


def write_eurosat(root):
    """The CoOp EuroSAT split file (8100 test images, 810 a class; no train
    or val rows) under root/eurosat; the images are never read. Returns the
    dataset path."""
    path = os.path.join(root, "eurosat")
    os.makedirs(path, exist_ok=True)
    per_class = EUROSAT_TEST // len(EUROSAT_CLASSES)
    test = [[f"{name.replace(' ', '')}/{name.replace(' ', '')}_{i}.jpg",
             label, name]
            for label, name in enumerate(EUROSAT_CLASSES)
            for i in range(per_class)]
    with open(os.path.join(path, "split_zhou_EuroSAT.json"), "w") as f:
        json.dump({"train": [], "val": [], "test": test}, f)
    return path


def write_bpe(root):
    import gzip

    path = os.path.join(root, "bpe_synthetic.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("\n".join(BPE_MERGES) + "\n")
    return path


def pixel_batches(labels, size, batch, seed):
    """uint8 [b, size, size, 3] batches made on the card from ``seed``, with
    their labels (numpy)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    for start in range(0, len(labels), batch):
        y = labels[start:start + batch]
        yield torch.randint(0, 256, (len(y), size, size, 3), generator=g,
                            dtype=torch.uint8, device="cuda"), y


def set_routes(model, attn_impl, fuse):
    """Switch a loaded model between the kernel route and the plain route on
    the same weights: the attention modules' ``attn_impl``, and ``fuse`` on
    the identity bottlenecks K5 takes (``model.fused_blocks``)."""
    from transductive_clip_tpu_torch.models.clip.layers import (
        MultiHeadAttention,
    )

    for m in model.module.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = attn_impl
    for block in model.fused_blocks:
        block.fuse = fuse


def attention_probes(model):
    """name -> the first and the last MultiHeadAttention module of each
    transformer tower of a loaded model."""
    from transductive_clip_tpu_torch.models.clip.layers import Transformer

    probes = {}
    for name, m in model.module.named_modules():
        if isinstance(m, Transformer):
            last = len(m.resblocks) - 1
            probes[f"{name}.resblocks.0.attn"] = m.resblocks[0].attn
            probes[f"{name}.resblocks.{last}.attn"] = m.resblocks[last].attn
    return probes


def compare_routes(label, model, images, prompts, counters):
    """One batch's and the prompts' normalized features, kernel route vs
    plain route, under FEATURE_LIMIT[label]; the kernel route must launch
    kernels and the plain route none. The features alone can hide the
    attention kernels (with random weights an attention output is small
    beside the residual stream), so the outputs of the first and the last
    attention module of each transformer tower are compared between the
    two routes as well, under K4_LIMIT for their dtype."""
    import torch

    probes = attention_probes(model)

    def both():
        seen = {}
        hooks = [m.register_forward_hook(
            lambda _m, _in, out, name=name: seen.__setitem__(
                name, out.detach().clone()))
            for name, m in probes.items()]
        before = sum(w.launches for w in counters.values())
        img = model.encode_image_batch(images)
        txt = model.encode_text_prompts(prompts)
        launched = sum(w.launches for w in counters.values()) - before
        for h in hooks:
            h.remove()
        return ([t / t.norm(dim=-1, keepdim=True) for t in (img, txt)],
                launched, seen)

    fused, n_fused, seen_fused = both()
    set_routes(model, "xla", False)
    plain, n_plain, seen_plain = both()
    set_routes(model, "fused", True)
    if n_fused == 0 or n_plain != 0:
        fail(f"{label}: {n_fused} launches on the kernel route, {n_plain} on "
             "the plain route")
    for what, a, b in zip(("image", "text"), fused, plain):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"{label} {what} features, kernel route vs plain route: rel_diff "
            f"{rel:.3e} (limit {FEATURE_LIMIT[label]:.0e})")
        if not (torch.isfinite(a).all() and rel < FEATURE_LIMIT[label]):
            fail(f"{label} {what} features: kernel vs plain route {rel}")
    if set(seen_fused) != set(probes) or set(seen_plain) != set(probes):
        fail(f"{label}: an attention module of {sorted(probes)} did not run")
    for name in probes:
        a, b = seen_fused[name], seen_plain[name]
        limit = K4_LIMIT[str(a.dtype)[6:]]
        _, rel = _rel_err(f"{label} {name} output, kernel route vs plain "
                          "route", a, b, limit)
        log(f"{label} {name} output {list(a.shape)} {str(a.dtype)[6:]}, "
            f"kernel route vs plain route: rel_diff {rel:.3e} (limit "
            f"{limit:.0e})")


def time_routes(label, model, images):
    """One batch through the image tower on the kernel route and on the
    model's own plain route (``fused_resnet`` off: cuDNN's convolutions in
    the compute dtype), one after the other on the same weights."""
    kernel_ms = time_ms(lambda: model.encode_image_batch(images), runs=3)
    set_routes(model, "fused", False)
    try:
        plain_ms = time_ms(lambda: model.encode_image_batch(images), runs=3)
    finally:
        set_routes(model, "fused", True)
    n = len(images)
    log(f"{label} image tower, one batch of {n} ({model.compute_dtype}): "
        f"fused_resnet=True {kernel_ms:.4f} ms ({kernel_ms / n:.4f} ms per "
        f"image), fused_resnet=False {plain_ms:.4f} ms ({plain_ms / n:.4f} "
        "ms per image)")


def profile_encode(label, model, images):
    """Device busy share and top kernels of one steady encode batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    model.encode_image_batch(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.encode_image_batch(images)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(label, prof, wall_us, 0, top=8)


def extract(label, model, args, dataset, items, size, batch, counters):
    """The extraction main path with every kernel count set to 0 just
    before: text features (get_text_features), then the factored
    extract_to_caches over seeded pixel batches to the T = 30 softmax cache.
    Returns (cache path, launches, seconds, first batch)."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch.eval.extraction import (
        extract_to_caches,
        get_text_features,
    )
    from transductive_clip_tpu_torch.features.cache import softmax_cache_path

    labels = np.array([d.label for d in items], np.int64)
    path = softmax_cache_path("eurosat", "test", args.backbone, 30,
                              root=args.root)
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = get_text_features(args, model, dataset.classnames,
                             dataset.template)
    t_text = time.perf_counter() - t0
    emb, got_labels = extract_to_caches(
        model, pixel_batches(labels, size, batch, SEED), [(30, path)], text)
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}
    n_batches = -(-len(labels) // batch)
    log(f"extraction {label}: {len(labels)} images in {n_batches} batches, "
        f"{seconds:.3f} s ({1e3 * (seconds - t_text) / len(labels):.4f} ms "
        f"per image; text features {1e3 * t_text:.1f} ms) launches "
        f"{launches}")
    if not (np.isfinite(emb).all() and np.array_equal(got_labels, labels)):
        fail(f"extraction {label}: non-finite features or wrong labels")
    first = next(pixel_batches(labels, size, batch, SEED))[0]
    return path, launches, n_batches, first


def run_extraction(root, counters, records, launches):
    """Phases extraction_rn50 and extraction_vitl336_fp32."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.core.config import CfgNode
    from transductive_clip_tpu_torch.data import build_dataset
    from transductive_clip_tpu_torch.features.cache import load_feature_cache
    from transductive_clip_tpu_torch.models.clip import (
        CLIP_CONFIGS,
        init_random_state_dict,
        load,
    )

    weights = os.path.join(root, "clip_weights")
    os.makedirs(weights)
    os.environ["CLIP_WEIGHTS_DIR"] = weights
    os.environ["CLIP_BPE_PATH"] = write_bpe(root)
    dataset_path = write_eurosat(root)
    dataset = build_dataset("eurosat", dataset_path)
    prompts = [dataset.template.format(c) for c in dataset.classnames]
    with Phase("extraction_rn50"):
        torch.save(init_random_state_dict(CLIP_CONFIGS["RN50"], SEED),
                   os.path.join(weights, "RN50.pt"))
        model, _ = load("RN50", fused_resnet=True)
        model.fused_blocks = [b for b in model.module.visual.blocks()
                              if b.fuse]
        log(f"RN50: {model.compute_dtype} attention {model.attention_impl} "
            f"fold_bn {model.fold_bn} fused blocks {len(model.fused_blocks)}")
        args = CfgNode(dict(dataset="eurosat", backbone="RN50", root=root,
                            dataset_path=dataset_path))
        path, got, n_batches, first = extract(
            "RN50", model, args, dataset, dataset.test, 224, EXTRACT_BATCH,
            counters)
        if (got["fused_identity_bottleneck"] != 12 * n_batches
                or got["attention_rows"] != 12
                or got["attention_blocked"] != 0):
            fail(f"RN50 extraction launched {got}, not K5 12 a batch "
                 f"({12 * n_batches}) and K4a 12 (one text batch)")
        launches["fused_identity_bottleneck"] = got["fused_identity_bottleneck"]
        launches["attention_rows"] = got["attention_rows"]
        feats, _ = load_feature_cache(path)
        if feats.shape != (EUROSAT_TEST, len(EUROSAT_CLASSES)) or not (
                np.isfinite(feats).all()
                and np.allclose(feats.sum(-1), 1.0, atol=1e-4)):
            fail(f"RN50 softmax cache: shape {feats.shape} or not simplex "
                 "rows")
        compare_routes("RN50", model, first, prompts, counters)
        time_routes("RN50", model, first)
        profile_encode("RN50 encode, one batch of 512", model, first)
        del model, first
        torch.cuda.empty_cache()
    with Phase("zero_shot_eval_rn50_cache"):
        acc, sec_per_task = cli.main(
            ["--config-root", os.path.join(HERE, "config"), "--opts",
             "dataset", "eurosat", "method", "em_dirichlet", "shots", "0",
             "backbone", "RN50", "root", root, "dataset_path", dataset_path,
             "number_tasks", "200", "batch_size", "100", "save_results",
             "False", "log_path", os.path.join(root, "logs")])
        log(f"zero-shot em_dirichlet on the RN50 cache (random weights): "
            f"accuracy {acc:.6f} ms_per_task {1e3 * sec_per_task:.4f}")
        if not 0.0 <= acc <= 1.0:
            fail(f"zero-shot accuracy {acc} outside [0, 1]")
    with Phase("extraction_vitl336_fp32"):
        name = "ViT-L/14@336px"
        model, _ = load(name, allow_random=True, seed=SEED,
                        compute_dtype=torch.float32)
        model.fused_blocks = []
        if model.attention_impl != "fused":
            fail(f"{name} fp32 resolved attention to {model.attention_impl}")
        args = CfgNode(dict(dataset="eurosat", backbone=name, root=root,
                            dataset_path=dataset_path))
        items = dataset.test[::VIT_EVERY]
        path, got, n_batches, first = extract(
            name, model, args, dataset, items, 336, VIT_BATCH, counters)
        layers = CLIP_CONFIGS[name].vision.layers
        if (got["attention_blocked"] != layers * n_batches
                or got["attention_rows"] != 12):
            fail(f"{name} extraction launched {got}, not K4b {layers} a "
                 f"batch ({layers * n_batches}) and K4a 12")
        launches["attention_blocked"] = got["attention_blocked"]
        records["attention_rows"]["vit_path_launches"] = got["attention_rows"]
        feats, _ = load_feature_cache(path)
        if feats.shape != (len(items), len(EUROSAT_CLASSES)) or not (
                np.isfinite(feats).all()):
            fail(f"{name} softmax cache: shape {feats.shape}")
        compare_routes(name, model, first, prompts, counters)
        del model, first
        torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    try:
        from transductive_clip_tpu_torch.ops import cuda_attention as ca
        from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb
        from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd
        from transductive_clip_tpu_torch.ops import cuda_tim as ct
        from transductive_clip_tpu_torch.ops import kernel_build
        from transductive_clip_tpu_torch.ops.common import resolve_device
    except ImportError as e:
        fail(f"the transductive_clip_tpu_torch package is not beside this "
             f"script ({e})")
    if not os.path.abspath(cd.__file__).startswith(HERE + os.sep):
        fail(f"the port was imported from {cd.__file__}, not from the "
             f"checkout beside this script ({HERE})")
    # the few-shot evaluator reads its tuned parameters from the val grids
    # under results_few_shot/, relative to the working directory
    os.chdir(HERE)
    resolve_device("cuda")   # TF32 off for the plain versions' products

    with Phase("setup"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        kernel_build.build()
        log(f"kernel build seconds {time.perf_counter() - t0:.3f}")
        for source, text in kernel_build.build_log.items():
            for line in text.splitlines():
                if ("registers" in line or "spill" in line or "error" in line
                        or "Function properties" in line):
                    log(f"ptxas {source}: {line.strip()}")

    kernels = {
        "dirichlet_row_solve": (cd.dirichlet_row_solve,
                                cd.dirichlet_row_solve_reference,
                                "transductive_clip_tpu/ops/pallas_dirichlet.py:56",
                                "dirichlet_solve.cu"),
        "mm_row_solve": (cd.mm_row_solve, cd.mm_row_solve_reference,
                         "transductive_clip_tpu/ops/pallas_dirichlet.py:92",
                         "dirichlet_solve.cu"),
        "tim_support_grad": (ct.tim_support_grad,
                             ct.tim_support_grad_reference,
                             "transductive_clip_tpu/ops/pallas_tim.py:44",
                             "tim_support_grad.cu"),
        "attention_rows": (ca.attention_rows, ca.fused_attention_reference,
                           "transductive_clip_tpu/ops/pallas_attention.py:92",
                           "attention.cu"),
        "attention_blocked": (ca.attention_blocked,
                              ca.fused_attention_reference,
                              "transductive_clip_tpu/ops/pallas_attention.py:117",
                              "attention.cu"),
        "fused_identity_bottleneck": (
            cb.fused_identity_bottleneck,
            cb.fused_identity_bottleneck_reference,
            "transductive_clip_tpu/ops/pallas_bottleneck.py:91",
            "bottleneck.cu"),
    }
    records = {}
    with Phase("kernels_vs_plain"):
        for shape, seed, timing in (((N_TASK, 91, N_CLASS), 1, True),
                                    ((N_TASK, 32, N_CLASS), 2, False),
                                    ((3, 13, 150), 3, False),
                                    ((8, N_CLASS, N_CLASS), 4, False)):
            a0, y = solve_inputs(*shape, seed)
            for name in ("dirichlet_row_solve", "mm_row_solve"):
                wrapper, plain, _, _ = kernels[name]
                rec = check_kernel(name, wrapper, plain, a0, y, timing)
                prev = records.setdefault(name, rec)
                prev["max_abs_err"] = max(prev["max_abs_err"], rec["max_abs_err"])
        a0, y = solve_inputs(N_TASK, 32, N_CLASS, 2)
        for name in ("dirichlet_row_solve", "mm_row_solve"):
            wrapper = kernels[name][0]
            records[name]["ms_rows32"] = time_ms(lambda: wrapper(a0, y))
            log(f"{name} [{N_TASK}, 32, {N_CLASS}]: ms "
                f"{records[name]['ms_rows32']:.4f}")
        del a0, y

    with Phase("k3_vs_plain"):
        protocol = (N_TASK, SHOTS * N_CLASS, N_CLASS, N_CLASS)
        rec = check_k3(protocol, "highest", "Shannon", 2.5, 5, True, True)
        rec_bf16 = check_k3(protocol, "default", "Shannon", 2.5, 5, True, True)
        errs = [rec["max_abs_err"], rec_bf16["max_abs_err"]]
        for precision in ("highest", "default"):
            for kind, alpha in (("Shannon", 1.0), ("Alpha", 2.5)):
                errs.append(check_k3((3, 13, 150, 97), precision, kind, alpha,
                                     6, False, False)["max_abs_err"])
                for seed, shape in enumerate(K3_EDGES, start=7):
                    errs.append(check_k3(shape, precision, kind, alpha, seed,
                                         False, False,
                                         outside=True)["max_abs_err"])
        rec["max_abs_err"] = max(errs)
        rec["default"] = rec_bf16
        records["tim_support_grad"] = rec
    run_kernel_checks_clip(records)

    counters = {name: k[0] for name, k in kernels.items()}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        with Phase("cache"):
            write_imagenet_cache(root, "test", PER_CLASS, SEED)
            write_imagenet_cache(root, "train", TRAIN_PER_CLASS, SEED + 1)
        zs = ["shots", "0"]
        with Phase("main_path_soft_pallas"):
            _, _, got, _ = run_main_path(
                root, "em_dirichlet solver=pallas",
                zs + ["method", "em_dirichlet", "dirichlet_solver", "pallas"],
                3 * N_TASK, counters)
            launches["dirichlet_row_solve"] = got["dirichlet_row_solve"]
            if got["dirichlet_row_solve"] <= 0:
                fail("the soft main path launched dirichlet_row_solve 0 times")
        with Phase("main_path_hard_mm_pallas"):
            _, _, got, _ = run_main_path(
                root, "hard_em_dirichlet solver=mm_pallas",
                zs + ["method", "hard_em_dirichlet", "dirichlet_solver",
                      "mm_pallas"],
                N_TASK, counters)
            launches["mm_row_solve"] = got["mm_row_solve"]
            if got["mm_row_solve"] <= 0:
                fail("the hard main path launched mm_row_solve 0 times")
        with Phase("default_config"):
            run_main_path(root, "em_dirichlet solver=auto",
                          zs + ["method", "em_dirichlet", "dirichlet_solver",
                                "auto"],
                          N_TASK, counters)
        run_few_shot(root, counters, records, launches)
        with Phase("profile"):
            for solver in ("pallas", "auto"):
                profile_batch(root, solver)
        run_extraction(root, counters, records, launches)

    listing = []
    for name, (_, _, replaces, source) in kernels.items():
        rec = records[name]
        listing.append({
            "name": name, "route": "cuda",
            "source": f"transductive_clip_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            **{key: rec[key] for key in ("few_shot_launches",
                                         "vit_path_launches") if key in rec},
        })
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
