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
   [100, 4000, 1000, 1000] in 'highest' and 'default' and at a ragged
   [3, 13, 150, 97] with non-uniform labels: max difference over the
   output's magnitude < 1e-5 ('highest') and < 1e-2 ('default');
   kernel and plain times (CUDA events, median of 5 after a warm-up) beside
   the least time the card could take;
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
   EM-Dirichlet with ``pallas`` and with ``auto``.

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


def time_ms(fn, runs=5):
    """Median milliseconds of ``fn`` on the card (CUDA events), after a
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
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


def k3_inputs(n, s, k, d, seed, uniform):
    """Support rows on the simplex peaked at their label (softmax features),
    labels — ``uniform``: s / k of each class, shuffled per task, as the
    sampler's support; else random and non-uniform — and weights at the
    support class means plus noise, as the Adam steps see them."""
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
    return x, y, w


def check_k3(shape, precision, kind, alpha, seed, uniform, timing):
    """K3 vs its plain version on the card; returns the record fields."""
    import torch

    from transductive_clip_tpu_torch.ops import cuda_tim as ct

    n, s, k, d = shape
    x, y, w = k3_inputs(n, s, k, d, seed, uniform)
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
    torch.cuda.empty_cache()
    return out


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
    TIM's one-time setup: K3's three passes, the query side's products
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
    k3 = sum(_dev_us(e) for e in events
             if "support_" in e.key or "half_sq_norm" in e.key)
    gemm = sum(_dev_us(e) for e in events
               if "gemm" in e.key.lower() or "cutlass" in e.key.lower())
    _, grads = grad_fn(w)
    adam_ms = time_ms(lambda: ttim._adam_step(w, grads, state, lr, opt_dtype))
    if busy > 0:
        log(f"profile alpha-TIM per step: K3 {k3 / 1e3 / n_steps:.3f} ms "
            f"(share {k3 / busy:.4f}), gemm {gemm / 1e3 / n_steps:.3f} ms "
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    try:
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
        rec["max_abs_err"] = max(errs)
        rec["default"] = rec_bf16
        records["tim_support_grad"] = rec

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

    listing = []
    for name, (_, _, replaces, source) in kernels.items():
        rec = records[name]
        listing.append({
            "name": name, "route": "cuda",
            "source": f"transductive_clip_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            **({"few_shot_launches": rec["few_shot_launches"]}
               if "few_shot_launches" in rec else {}),
        })
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
