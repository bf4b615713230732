#!/usr/bin/env python
"""Run the PyTorch port's 15 methods on synthetic separable features: an
end-to-end smoke run of every method with no CLIP weights and no dataset
(counterpart of scripts/run_synthetic_protocol.py).

    python scripts/run_synthetic_protocol_torch.py [--n-class 100] [--tasks 200]
    python scripts/run_synthetic_protocol_torch.py --quick --check
    python scripts/run_synthetic_protocol_torch.py --quick --device cpu

It runs on the card (``cuda:0``) unless ``--device`` names another device,
e.g. ``cpu``. Rows stream as each method finishes. ``--quick`` shrinks the
shapes and iteration counts (K = 32, 32 tasks x 25 queries in batches of
16, 4 shots); ``--check`` then holds every method to the floors of
QUICK_CHECK_BOUNDS (a copy of the JAX script's) and, on a CUDA device, to
its latency ceiling, and exits non-zero when one misses. The Dirichlet,
hard k-means and KL methods should be near 1.0 on these separable simplex
tasks; the Gaussian and soft k-means baselines score lower at large K,
the paper's core finding (Table 1).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from transductive_clip_tpu_torch.core.config import CfgNode  # noqa: E402
from transductive_clip_tpu_torch.methods import (  # noqa: E402
    FEW_SHOT_METHODS,
    ZERO_SHOT_METHODS,
    get_few_shot_method,
    get_zero_shot_method,
)
from transductive_clip_tpu_torch.ops.common import resolve_device  # noqa: E402
from transductive_clip_tpu_torch.utils.synthetic import (  # noqa: E402
    make_few_shot_tasks,
    make_zero_shot_tasks,
)

# --check bounds of the --quick protocol (K=32, 32 tasks x 25 queries,
# shots=4, seed 0): (min final accuracy, max ms/task), a copy of
# scripts/run_synthetic_protocol.py's. Accuracy is checked on every device;
# the latency ceiling only on a CUDA device, where it catches a
# catastrophic regression (the JAX script checks it on the TPU)
QUICK_CHECK_BOUNDS = {
    # zero-shot
    "KL_KMEANS": (0.95, 1000.0),
    "EM_DIRICHLET": (0.95, 1000.0),
    "HARD_EM_DIRICHLET": (0.95, 1000.0),
    "EM_GAUSSIAN": (0.75, 1000.0),
    "EM_GAUSSIAN_COV": (0.55, 1000.0),
    "SOFT_KMEANS": (0.55, 1000.0),
    "HARD_KMEANS": (0.95, 1000.0),
    "CLIP": (0.95, 1000.0),
    # few-shot
    "FS/EM_DIRICHLET": (0.95, 1000.0),
    "FS/HARD_EM_DIRICHLET": (0.95, 1000.0),
    "FS/PADDLE": (0.95, 1000.0),
    "FS/BDCSPN": (0.95, 1000.0),
    "FS/LAPLACIAN_SHOT": (0.95, 1000.0),
    "FS/ALPHA_TIM": (0.95, 2000.0),
    "FS/TIM-GD": (0.95, 2000.0),
}


def check_results(rows, backend):
    """Acceptance gate for ``--quick --check``: every method present, every
    accuracy above its floor, and on ``backend`` 'cuda' every latency under
    its ceiling. Returns a list of failure strings (empty = pass)."""
    failures = []
    seen = {name for name, _, _ in rows}
    for name in sorted(set(QUICK_CHECK_BOUNDS) - seen):
        failures.append(f"{name}: missing from results")
    for name, acc, ms in rows:
        if name not in QUICK_CHECK_BOUNDS:
            failures.append(f"{name}: no bound (update QUICK_CHECK_BOUNDS)")
            continue
        min_acc, max_ms = QUICK_CHECK_BOUNDS[name]
        if acc < min_acc:
            failures.append(
                f"{name}: accuracy {acc:.3f} < floor {min_acc:.2f}")
        if backend == "cuda" and ms > max_ms:
            failures.append(
                f"{name}: {ms:.1f} ms/task > ceiling {max_ms:.0f}")
    return failures


def base_cfg(n_class, n_query, batch_size, shots):
    return CfgNode(dict(
        num_classes_test=n_class, n_class=n_class, n_query=n_query,
        k_eff=5, shots=shots, batch_size=batch_size, iter=20, iter_mm=1000,
        T=30, use_softmax_feature=True, graph_matching=True, seed=0,
        lambd=5.0, temp=30.0, norm_type="L2N", knn=3, lmd=0.7,
        loss_weights=[1.0, 1.0, 1.0], entropies=["Shannon", "Alpha", "Alpha"],
        alpha_value=5.0, lr_alpha_tim=1e-4, lr_tim=1e-4,
    ))


def run(args, log=print):
    """All 15 methods; returns rows (bound key, final acc, steady
    ms/task)."""
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    log(f"device: {device}, K={args.n_class}, {args.tasks} tasks x "
        f"{args.n_query} queries")
    results = []

    log(f"\n{'zero-shot method':<22} {'acc':>6} {'ms/task':>9}")
    for name in ZERO_SHOT_METHODS:
        cfg = base_cfg(args.n_class, args.n_query, args.batch_size, 0)
        if name in ("HARD_EM_DIRICHLET", "HARD_KMEANS", "KL_KMEANS"):
            cfg.iter = 10
        if args.quick:
            cfg.iter, cfg.iter_mm = min(cfg.iter, 10), 100
        method = get_zero_shot_method(name, device=device, args=cfg)
        accs, times = [], []
        n_batches = max(1, args.tasks // args.batch_size)
        for b in range(n_batches):
            x, y = make_zero_shot_tasks(rng, args.batch_size, args.n_query,
                                        args.n_class)
            logs = method.run_task({"x_q": x, "y_q": y})
            if b > 0 or n_batches == 1:   # the first batch warms up
                times.append(logs["timestamps"])
            accs.append(logs["acc"][:, -1].mean())
        log(f"{name:<22} {np.mean(accs):>6.3f} {np.mean(times)*1e3:>9.2f}")
        results.append((name, float(np.mean(accs)),
                        float(np.mean(times)) * 1e3))

    log(f"\n{'few-shot method':<22} {'acc':>6} {'ms/task':>9}")
    fs_batch = min(args.batch_size, max(1, 2000 // args.n_class))
    for name in FEW_SHOT_METHODS:
        cfg = base_cfg(args.n_class, args.n_query, fs_batch, args.shots)
        if name in ("ALPHA_TIM", "TIM-GD"):
            cfg.iter = 1000
        if args.quick:
            cfg.iter = min(cfg.iter, 100)
            cfg.iter_mm = 100
        method = get_few_shot_method(name, device=device, args=cfg)
        xs, ys, xq, yq = make_few_shot_tasks(
            rng, fs_batch, args.n_query, args.n_class, args.shots)
        task = {"x_s": xs, "y_s": ys, "x_q": xq, "y_q": yq}
        method.run_task(task, shot=args.shots)
        # a second run for the steady time
        logs = method.run_task(task, shot=args.shots)
        log(f"{name:<22} {logs['acc'][:, -1].mean():>6.3f} "
            f"{logs['timestamps']*1e3:>9.2f}")
        results.append((f"FS/{name}", float(logs["acc"][:, -1].mean()),
                        float(logs["timestamps"]) * 1e3))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-class", type=int, default=100)
    ap.add_argument("--tasks", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--n-query", type=int, default=75)
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card (default) or 'cpu'")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes and fewer iterations")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero when a method misses its accuracy "
                         "floor (or, on a CUDA device, its latency "
                         "ceiling); needs --quick, whose bounds they are")
    args = ap.parse_args(argv)
    if args.check and not args.quick:
        ap.error("--check bounds are those of the --quick protocol; pass "
                 "--quick too")
    if args.quick:
        # 2 batches: the first is left out of the time
        args.n_class, args.tasks, args.batch_size, args.n_query = 32, 32, 16, 25

    def log(msg):
        print(msg, flush=True)

    results = run(args, log)
    if args.check:
        failures = check_results(results, resolve_device(args.device).type)
        if failures:
            log("\n--check FAILED:")
            for f in failures:
                log(f"  {f}")
            sys.exit(1)
        log(f"\n--check passed: {len(results)} methods within their bounds")
    return results


if __name__ == "__main__":
    main()
