#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each timed on a line of its own; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, and the build of
   every kernel from ``transductive_clip_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together);
2. each kernel against its plain torch version on the card, at the main
   path's shapes [100, 91, 1000] and [100, 32, 1000], a ragged
   [3, 13, 150] and a full-width [8, 1000, 1000] (K2's width on the
   guard's exact first iteration; its last block is ragged): inputs built
   as the EM step builds them, max relative difference < 1e-3,
   stationarity residual < 5e-3 on live rows, frozen
   rows bit-equal; kernel and plain times (CUDA events, median of 5 after a
   warm-up) beside the least time the card could take;
3. the main path, soft EM-Dirichlet at the ImageNet protocol (100 tasks x
   75 queries x K = 1000, three batches) through the port's CLI with
   ``dirichlet_solver pallas`` on a synthetic softmax cache;
4. the same, hard EM-Dirichlet with ``dirichlet_solver mm_pallas``;
5. one batch of the default configuration (``dirichlet_solver auto``);
6. a torch.profiler breakdown of one steady-state batch of the soft main
   path, with ``pallas`` and with ``auto``.

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
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s
# and fp32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
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
MIN_ACCURACY = 0.95


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
    """Kernel vs plain version on the card; returns the record fields."""
    import torch

    from transductive_clip_tpu_torch.ops.cuda_dirichlet import ROW_FREEZE

    got = wrapper(a0, y)
    if got.is_cuda:
        torch.cuda.synchronize()
    ref, iters = plain(a0, y, return_iters=True)
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


def write_imagenet_cache(root):
    """A synthetic ImageNet-shaped softmax cache: 1000 classes x 50 images,
    each drawn from a Dirichlet peaked at its class (concentration 60, as
    utils/synthetic.py draws them)."""
    import numpy as np

    from transductive_clip_tpu_torch.features.cache import (
        save_feature_cache,
        softmax_cache_path,
    )

    rng = np.random.default_rng(SEED)
    labels = np.repeat(np.arange(N_CLASS), PER_CLASS)
    conc = np.ones((labels.size, N_CLASS))
    conc[np.arange(labels.size), labels] += 60.0
    feats = rng.gamma(conc).astype(np.float32)
    feats /= feats.sum(-1, keepdims=True)
    save_feature_cache(softmax_cache_path("imagenet", "test", "RN50", 30,
                                          root=root), feats, labels)


def run_main_path(root, method, solver, number_tasks, counters):
    """The port's CLI entry, in process; returns (accuracy, ms/task over the
    batches after the first, launches by kernel, host syncs per batch)."""
    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.methods.base import TransductiveMethod
    from transductive_clip_tpu_torch.ops.common import to_host

    opts = ["dataset", "imagenet", "method", method, "shots", "0",
            "number_tasks", str(number_tasks), "batch_size", str(N_TASK),
            "n_query", str(N_QUERY), "dirichlet_solver", solver,
            "root", root, "save_results", "False",
            "log_path", os.path.join(root, "logs")]
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
            f"em_iterations {len(logs['timestamps_cumulative'])} launches "
            f"{dict(zip(counters, delta[:-1]))} host_syncs {delta[-1]}")
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
    log(f"main path {method} solver={solver}: accuracy {acc:.6f} "
        f"ms_per_task {1e3 * sec_per_task:.4f} batches {n_batches} "
        f"launches {launches} host_syncs_per_batch {syncs:.2f}")
    if not acc > MIN_ACCURACY:
        fail(f"{method}/{solver}: accuracy {acc} <= {MIN_ACCURACY}")
    return acc, 1e3 * sec_per_task, launches, syncs


def profile_batch(root, solver):
    """Where one steady-state batch of the soft main path spends its time:
    the method's run_task on a second sampled batch (the first one hosts
    the compact_first guard and the warm-up) under torch.profiler; prints
    the top kernels by device time and the device's busy share of the wall
    clock."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
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
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key != "Activity Buffer Request"]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events)
    log(f"profile {solver}: batch wall_ms {wall_us / 1e3:.3f} device_busy_ms "
        f"{busy / 1e3:.3f} busy_share {busy / wall_us:.4f} host_syncs "
        f"{to_host.syncs}")
    if busy <= 0:
        log(f"profile {solver}: the profiler recorded no device time")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        if dev_us(e) > 0:
            log(f"profile {solver}: {dev_us(e) / 1e3:9.3f} ms "
                f"{e.count:6d} calls  {e.key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    try:
        from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd
        from transductive_clip_tpu_torch.ops import kernel_build
    except ImportError as e:
        fail(f"the transductive_clip_tpu_torch package is not beside this "
             f"script ({e})")
    if not os.path.abspath(cd.__file__).startswith(HERE + os.sep):
        fail(f"the port was imported from {cd.__file__}, not from the "
             f"checkout beside this script ({HERE})")

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
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"ptxas {source}: {line.strip()}")

    kernels = {
        "dirichlet_row_solve": (cd.dirichlet_row_solve,
                                cd.dirichlet_row_solve_reference,
                                "transductive_clip_tpu/ops/pallas_dirichlet.py:56"),
        "mm_row_solve": (cd.mm_row_solve, cd.mm_row_solve_reference,
                         "transductive_clip_tpu/ops/pallas_dirichlet.py:92"),
    }
    records = {}
    with Phase("kernels_vs_plain"):
        for shape, seed, timing in (((N_TASK, 91, N_CLASS), 1, True),
                                    ((N_TASK, 32, N_CLASS), 2, False),
                                    ((3, 13, 150), 3, False),
                                    ((8, N_CLASS, N_CLASS), 4, False)):
            a0, y = solve_inputs(*shape, seed)
            for name, (wrapper, plain, _) in kernels.items():
                rec = check_kernel(name, wrapper, plain, a0, y, timing)
                prev = records.setdefault(name, rec)
                prev["max_abs_err"] = max(prev["max_abs_err"], rec["max_abs_err"])
        a0, y = solve_inputs(N_TASK, 32, N_CLASS, 2)
        for name, (wrapper, plain, _) in kernels.items():
            records[name]["ms_rows32"] = time_ms(lambda: wrapper(a0, y))
            log(f"{name} [{N_TASK}, 32, {N_CLASS}]: ms "
                f"{records[name]['ms_rows32']:.4f}")

    counters = {name: k[0] for name, k in kernels.items()}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        with Phase("cache"):
            write_imagenet_cache(root)
        with Phase("main_path_soft_pallas"):
            _, _, got, _ = run_main_path(root, "em_dirichlet", "pallas", 300,
                                         counters)
            launches["dirichlet_row_solve"] = got["dirichlet_row_solve"]
            if got["dirichlet_row_solve"] <= 0:
                fail("the soft main path launched dirichlet_row_solve 0 times")
        with Phase("main_path_hard_mm_pallas"):
            _, _, got, _ = run_main_path(root, "hard_em_dirichlet",
                                         "mm_pallas", 100, counters)
            launches["mm_row_solve"] = got["mm_row_solve"]
            if got["mm_row_solve"] <= 0:
                fail("the hard main path launched mm_row_solve 0 times")
        with Phase("default_config"):
            run_main_path(root, "em_dirichlet", "auto", 100, counters)
        with Phase("profile"):
            for solver in ("pallas", "auto"):
                profile_batch(root, solver)

    listing = []
    for name, (_, _, replaces) in kernels.items():
        rec = records[name]
        listing.append({
            "name": name, "route": "cuda",
            "source": "transductive_clip_tpu_torch/csrc/dirichlet_solve.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
