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
   guard's exact first iteration; its last block is ragged), and untimed at
   the edges of the cluster design (dirichlet_fixtures.SOLVE_EDGES): inputs
   built as the EM step builds them, max relative difference < 1e-3,
   stationarity residual < 5e-3 on live rows, frozen rows bit-equal; the
   kernels' times (10 calls queued a timed window) beside the operations
   bound and the special-function unit's (SFU_PER_UPDATE), and K2 alone at
   the few-shot full width [100, 1000, 1000]; special.cuh's fast paths
   against IEEE fp32 on every float of their domains
   (csrc/special_check.cu);
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
   ``mm_pallas`` (both with blocking batches, ``defer_fetch false``, so
   that their ms per task is the method's own time), and the default
   configuration; every run fails if a batch's matching left the card for
   the host JV solver (the auction out of rounds) where that is not forced;
   then soft ``pallas`` on
   the four routes of ZS_ROUTES (blocking with host JV matching, blocking,
   deferred and fused with the device auction), PIPELINE_BATCHES batches
   each: every batch's predictions and accuracies bit-equal across them,
   each route's steady window (batches 1 on: wall clock per task, host
   syncs per batch, and in a second, profiled run the device's busy
   share), the auction's exhausted-budget fallback forced once on the
   fused route (equal to the host route), and the native LAP loaded
   (phase zero_shot_pipelines); the auction kernel against its plain
   version, col4row, rounds and scans equal, on that phase's first device
   batch's values [100, 75, 1000], on random ones, at the edges (C = 1,
   R = 1, R = C, C = 63, rows of zeros), on rows it groups or must not
   (repeated rows, rows one ulp apart, rows of -0.0 and of +0.0, many
   distinct rows at C = 2000), on the 5 x 5 price wars of
   values on a 0.25 grid and with the budget run out, each case's rounds
   and scans, and ms (ten calls a timed window, and one, beside the first
   design's figure quoted from PERF.md), the bound (the values read once;
   logged beside, with every bid's row read again) and the plain version's
   on the timed ones, and the ms a round on the zero-shot batch
   (auction_vs_plain);
5. the few-shot main path through the CLI at the 4-shot ImageNet protocol
   (support 4 x 1000 rows, 75 queries, 100 tasks a batch) on synthetic
   train and test caches, with blocking batches: alpha-TIM with
   ``tim_grad_impl pallas`` (two
   batches, K3 once per Adam step), the same batch with ``autodiff`` (the
   predictions and u compared), one batch with ``tim_matmul_precision
   default`` (K3's bf16 path), and few-shot EM-Dirichlet soft with
   ``pallas`` (K1) and hard with ``mm_pallas`` (K2), whose two full-width
   K2 launches ([100, 1000, 1000]: iteration 1 and the pure-support fixed
   point) are held against the plain version on their own inputs, as in
   phase 2; a torch.profiler breakdown of three steady alpha-TIM Adam steps
   with K3; few-shot EM-Dirichlet ``pallas`` (three batches) and alpha-TIM
   ``pallas`` (two) deferred and fused against blocking, batch for batch
   (few_shot_pipelines);
6. torch.profiler breakdowns of one steady batch of zero-shot soft
   EM-Dirichlet with ``pallas`` (K1's device time and launches) and with
   ``auto`` (its host syncs);
7. K4a and K4b against their plain version (the TPU kernels' order of
   operations in torch ops) at the text towers' shapes ([1000, 77, 3 x 512]
   bf16 with the causal mask, [1000, 77, 3 x 768] fp32), at
   ViT-L/14@336px's [64, 577, 3 x 1024] in fp32 and bf16, at ViT-B/16's
   [256, 197, 3 x 768] bf16, and untimed at ragged shapes, K4a's tile
   edges (n = 80, 128) and n = 577 bf16, without a mask, with the causal
   one and with a general one that kills whole key tiles for some rows; K5
   against its plain version at the four RN50 identity shapes at batch 512
   in bf16 and at batch 64 in fp32 (each summed over the 12 launches of a
   batch, the fp32 shapes with the weight bytes their blocks read from L2),
   and untimed at the edges of the kernels' tiles (W not a multiple of 8,
   Cm = 24 and 72, an image smaller than a strip, a last strip of one row,
   rows off 16 bytes); max difference over the output's magnitude
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
   batch; then RN50 under float32 (``fused_resnet=True``: K5's fp32 kernel
   on the 12 identity blocks of every batch, K4a in the text tower) over
   every 32nd image of that split (254 images, cut from 8100), batches of
   64, to its own T = 30 cache, one batch's features held against the plain
   route (cuDNN's fp32 convolutions, TF32 off) under 1e-4, and one batch
   timed on both routes; with the bf16 model still loaded, one CLI call
   of soft k-means with ``use_softmax_feature False`` on that split
   (zero_shot_visual_rn50): the evaluator extracts the visual cache (K5 12
   launches a batch, pixels made on the card in place of the decoded
   images) and evaluates it to its TSV row;
9. ViT-L/14@336px under float32 (K4b in the 24 image layers, K4a in the
   text tower) over every 32nd image of that split (254 images, cut from
   8100), batches of 64, its features and its first and last attention
   modules' outputs held against the 'xla' route on one batch;
10. the six other zero-shot methods (soft, hard and KL k-means,
   EM-Gaussian, EM-Gaussian-cov, inductive CLIP) through the CLI on the
   zero-shot softmax cache, two blocking batches each: accuracy (above
   ACCURACY_FLOOR), steady ms per task, auction launches (none for
   inductive CLIP) and no host-LAP fallback; soft k-means and
   EM-Gaussian-cov again on the default route (fused, with the auction),
   batch for batch equal to blocking (zero_shot_methods);
11. PADDLE, BD-CSPN and LaplacianShot through the CLI on the 4-shot
   caches with their tuned values from the val grids, two blocking
   batches each, and LaplacianShot on the default routes (it declines the
   pipelines), equal to blocking (few_shot_methods);
12. synthetic ImageNet-shaped visual caches at RN50's width (1024) with
   text prototypes: one blocking batch of each zero-shot method with
   ``use_softmax_feature False`` (EM-Dirichlet must refuse) and of
   PADDLE, BD-CSPN, LaplacianShot and alpha-TIM, each accuracy finite and
   in (0, 1] (visual_methods). Each of phases 8 (the visual call) and
   10-12 logs the card's name and power limit;
13. task data parallelism (parallel/; ``run_task_parallel``): in a task
   group of one rank (NCCL, in this process), soft EM-Dirichlet ``pallas``
   (K1) and ``auto`` (its Newton criterion gathered over the group every
   step) on the blocking and fused routes (the auction), hard
   ``mm_pallas`` (K2) and alpha-TIM ``pallas`` fp32 (K3) through the CLI,
   batch for batch equal to the runs without a group, with both ms per
   task and the collectives per batch (task_parallel_world1); then two
   ranks spawned on this card (NCCL, or gloo where NCCL refuses two ranks
   a card, its message logged): a zero-shot batch of ``pallas`` and of
   ``auto``, half the tasks a rank, equal to the single-process batch, and
   RN50 bf16 extraction (K5, K4a) over 1024 images, half of every batch a
   rank, its cache's top-1 labels equal to the single-process cache's
   (task_parallel_two_ranks). The kernels' launches in the group runs are
   ``task_parallel_launches`` in the kernels line;
14. class-axis tensor parallelism (``run_class_tp``): two ranks spawned
   on this card over gloo, laid out as dp 1 x tp 2, each holding half of
   every task's cluster rows or class weights: one zero-shot batch at the
   protocol of soft EM-Dirichlet ``pallas`` (K1 on the rows' shards, the
   compact_first guard included) and of hard ``mm_pallas`` (K2),
   CLASS_TP_FS_TASKS 4-shot tasks (K = d = 1000, 4000 support rows) of
   few-shot EM-Dirichlet ``pallas`` and of TIM_ITER_DEFAULT alpha-TIM steps
   (autodiff), each held against the same batch in this process
   (predictions and accuracies equal, u and the criterions within the
   tests' tp limits), with each run's collectives and bytes, every rank's
   peak card memory beside one process's, and first-batch ms per task;
   the kernels launched there are ``class_tp_launches`` in the kernels
   line (class_tp_two_ranks);
15. ``scripts/run_synthetic_protocol_torch.py --quick --check`` on the
   card, in a process of its own: all 15 methods above their accuracy
   floors and under their latency ceilings (synthetic_protocol).

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
# special-function-unit operations (MUFU) per live element and update, as
# cuobjdump -sass shows them: every reciprocal and division by a variable is
# one MUFU.RCP, expf one MUFU.EX2, sqrtf one MUFU.RSQ; logf (a polynomial)
# and a division by a constant (its reciprocal refined by FMAs) none. K1:
# the initial guess (expf or a reciprocal) + 3 Newton steps of 5
# reciprocals and a division; K2: digamma_lgamma_pos's 5 reciprocals, the
# curvature's and the root's divisions, sqrtf
SFU_PER_UPDATE = {"dirichlet_row_solve": 19, "mm_row_solve": 8}
# 16 MUFU operations a clock on each of the 132 SMs at the 1.98 GHz boost
# clock (the clock behind the data sheet's 67 TFLOP/s fp32)
PEAK_SFU_S = 132 * 16 * 1.98e9
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
FEATURE_LIMIT = {"RN50": 5e-2, "RN50 fp32": 1e-4, "ViT-L/14@336px": 1e-4}
# the extraction slice: EuroSAT as the CoOp split has it (8100 test images,
# 10 classes), batches of extract_batch_size 512; RN50 fp32 and
# ViT-L/14@336px on every 32nd test image in batches of 64
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
# K5 at the edges of the fp32 kernel's strips: a last strip of one row at
# W = 80, Cm = 72 (H = 5 in strips of 2, conv1 over two chunks of rows) and
# at W = 150, Cm = 24 with rows off 16 bytes (H = 7 in strips of 3), and
# Cm = 6, whose weight rows are off 16 bytes
K5_EDGES_F32 = ((1, 5, 80, 16, 72), (1, 7, 150, 30, 24), (2, 6, 5, 20, 6))
# the evaluator routes of phase zero_shot_pipelines (--opts) and the
# batches of each run; few-shot's routes (few_shot_pipelines)
ZS_ROUTES = {
    "blocking_host": ["defer_fetch", "false", "matching_backend", "host"],
    "blocking_device": ["defer_fetch", "false", "matching_backend", "device"],
    "deferred_device": ["defer_fetch", "true", "fused_dispatch", "false",
                        "matching_backend", "device"],
    "fused_device": ["defer_fetch", "true", "fused_dispatch", "true",
                     "matching_backend", "device"],
}
FS_ROUTES = {
    "blocking": ["defer_fetch", "false"],
    "deferred": ["defer_fetch", "true", "fused_dispatch", "false"],
    "fused": ["defer_fetch", "true", "fused_dispatch", "true"],
}
PIPELINE_BATCHES = 6
# the phases that time a path's method keep the blocking batches
# (defer_fetch: auto defers on the card), so that their ms per task stays
# the method's own time, comparable across PRs, and each batch is logged
BLOCKING = ["defer_fetch", "false"]
# the fp32 RN50 batch of the extraction_rn50_fp32 cut and of K5 fp32's
# headline ([64, 14, 14, 1024] / 256, as earlier kernel times were taken);
# K5 fp32 and the fp32 image tower are also timed at EXTRACT_BATCH, the
# batch an fp32 extraction runs by default
F32_BATCH = 64
# the methods of phases zero_shot_methods, few_shot_methods and
# visual_methods, and the accuracy each must pass on the synthetic softmax
# caches: the first H100 80GB HBM3 (700 W) run read 0.2363 (soft k-means,
# EM-Gaussian: at T = 30 their soft assignments over 1000 clusters are
# nearly flat, and the JAX package gives the same accuracies on such
# tasks), 0.9998 (hard k-means), 0.7622 (KL k-means), 0.2633
# (EM-Gaussian-cov) and 1.0 (inductive CLIP, PADDLE, BD-CSPN,
# LaplacianShot); the floors leave a margin under each
ZS_METHODS = ("soft_kmeans", "hard_kmeans", "kl_kmeans", "em_gaussian",
              "em_gaussian_cov", "inductive_clip")
FS_METHODS = ("paddle", "bdcspn", "laplacian_shot")
ACCURACY_FLOOR = {"soft_kmeans": 0.2, "hard_kmeans": 0.95, "kl_kmeans": 0.7,
                  "em_gaussian": 0.2, "em_gaussian_cov": 0.2,
                  "inductive_clip": 0.95, "paddle": 0.95, "bdcspn": 0.95,
                  "laplacian_shot": 0.95}
# the zero-shot methods whose default route (fused, with the auction) is
# held batch for batch against their blocking batches
FUSED_CHECKED = ("soft_kmeans", "em_gaussian_cov")
# the synthetic visual caches: RN50's embedding width, each image its
# class's unit text direction plus Gaussian noise of about the same norm
# (1 / sqrt(d) a coordinate), L2-normalized
VISUAL_DIM = 1024
VISUAL_NOISE = VISUAL_DIM ** -0.5
# phase task_parallel: batches of each zero-shot run in the world-1 group,
# and the images of the two-rank extraction (two batches of EXTRACT_BATCH)
TP_BATCHES = 3
TP_IMAGES = 2 * EXTRACT_BATCH
# phase class_tp_two_ranks: the few-shot tasks of its 4-shot runs
CLASS_TP_FS_TASKS = 20


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


def solve_inputs(n_task, n_rows, k, seed, hard_odd=True):
    """alpha0 = 1 and y as the EM step builds them, on the card
    (``dirichlet_fixtures.synthetic_solve_inputs``): even tasks dense, odd
    tasks hard with ROW_FREEZE rows, or every task dense."""
    from transductive_clip_tpu_torch.ops.dirichlet_fixtures import (
        synthetic_solve_inputs,
    )

    return synthetic_solve_inputs(n_task, n_rows, k, seed, n_query=N_QUERY,
                                  hard_odd=hard_odd)


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
            ms=time_ms(lambda: wrapper(a0, y), inner=10),
            plain_ms=time_ms(lambda: plain(a0, y)),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            sfu_bound_ms=updates * SFU_PER_UPDATE[name] / PEAK_SFU_S * 1e3,
        )
        log(f"{name} {shape}: ms {out['ms']:.4f} plain_ms "
            f"{out['plain_ms']:.4f} bound_ms {out['bound_ms']:.4f} "
            f"({out['bound_by']}: {ops:.4e} ops, {nbytes:.4e} bytes) "
            f"sfu_bound_ms {out['sfu_bound_ms']:.4f} ({updates:.4e} live "
            "element-updates)")
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


def run_main_path(root, label, opts, number_tasks, counters, on_batch=None,
                  window=None, host_fallbacks=0, min_accuracy=MIN_ACCURACY,
                  group=None):
    """The port's CLI entry, in process (``cli.run`` as a rank of
    ``group``, a task group, when one is given), with every kernel count
    set to 0 just before; returns (accuracy, ms/task over the batches after
    the first, launches by kernel, host syncs per batch). Each blocking batch is
    logged with its own counts (LaplacianShot's own ``run_task`` too);
    ``on_batch(method, logs)`` sees each one. Fails unless exactly
    ``host_fallbacks`` batches had their matching solved on the host after
    the device auction ran out of rounds (``note_host_fallback.count``; 0
    but where the test forces it), and unless the accuracy is finite, at
    most 1 and above ``min_accuracy``.

    ``window`` (a dict) asks for the steady window too, filled in: every
    batch's predictions and accuracies in batch order (``batches``: from
    the blocking run_task and the finalized deferred and fused results;
    ``deferred``: how many came from the latter), and
    from the end of the blocking batch 0 to the end of the evaluation (a
    synchronize at each end) its wall clock per task (``ms_per_task``), its
    host syncs per batch (``syncs``) and, with ``window["profile"]``, the
    device's busy share under torch.profiler (``busy_share``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.methods.base import (
        DeferredTaskResult,
        TransductiveMethod,
        note_host_fallback,
    )
    from transductive_clip_tpu_torch.methods.few_shot.laplacian_shot import (
        LAPLACIAN_SHOT,
    )
    from transductive_clip_tpu_torch.ops.common import to_host

    opts = ["dataset", "imagenet", "number_tasks", str(number_tasks),
            "batch_size", str(N_TASK), "n_query", str(N_QUERY),
            "root", root, "save_results", "False",
            "log_path", os.path.join(root, "logs"), *opts]
    for wrapper in counters.values():
        wrapper.launches = 0
    to_host.syncs = 0
    note_host_fallback.count = 0
    run_tasks = {cls: cls.run_task
                 for cls in (TransductiveMethod, LAPLACIAN_SHOT)}
    finalize = DeferredTaskResult.finalize
    batches, steady, deferred = [], {}, []

    def logged(run_task):
        def logged_run_task(self, task_dic, shot=None):
            """One batch of the evaluation, logged with its own counts."""
            before = [w.launches for w in counters.values()] + [to_host.syncs]
            logs = run_task(self, task_dic, shot)
            after = [w.launches for w in counters.values()] + [to_host.syncs]
            delta = [b - a for a, b in zip(before, after)]
            log(f"  batch: ms_per_task {1e3 * logs['timestamps']:.4f} "
                f"iterations {len(logs['timestamps_cumulative'])} accuracy "
                f"{logs['acc'][:, -1].mean():.6f} launches "
                f"{dict(zip(counters, delta[:-1]))} host_syncs {delta[-1]}")
            if on_batch is not None:
                on_batch(self, logs)
            batches.append((logs["preds"], logs["acc"]))
            if window is not None and not steady:
                torch.cuda.synchronize()
                if window.get("profile"):
                    steady["prof"] = profile(
                        activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
                    steady["prof"].start()
                steady.update(t0=time.perf_counter(), syncs0=to_host.syncs)
            return logs
        return logged_run_task

    def logged_finalize(self, host, elapsed_per_task):
        logs = finalize(self, host, elapsed_per_task)
        batches.append((logs["preds"], logs["acc"]))
        deferred.append(len(batches) - 1)
        return logs

    for cls, run_task in run_tasks.items():
        cls.run_task = logged(run_task)
    DeferredTaskResult.finalize = logged_finalize
    argv = ["--config-root", os.path.join(HERE, "config"), "--opts", *opts]
    try:
        if group is None:
            acc, sec_per_task = cli.main(argv)
        else:
            acc, sec_per_task = cli.run(cli.parse_args(argv), group)
    finally:
        for cls, run_task in run_tasks.items():
            cls.run_task = run_task
        DeferredTaskResult.finalize = finalize
    launches = {name: w.launches for name, w in counters.items()}
    n_batches = number_tasks // N_TASK
    syncs = to_host.syncs / n_batches
    log(f"main path {label}: accuracy {acc:.6f} ms_per_task "
        f"{1e3 * sec_per_task:.4f} batches {n_batches} launches {launches} "
        f"host_syncs_per_batch {syncs:.2f} host_fallbacks "
        f"{note_host_fallback.count}")
    if note_host_fallback.count != host_fallbacks:
        fail(f"{label}: {note_host_fallback.count} batches solved their "
             f"matching on the host after the device auction ran out of "
             f"rounds, not {host_fallbacks}")
    if not (acc > min_accuracy and acc <= 1.0):
        fail(f"{label}: accuracy {acc} outside ({min_accuracy}, 1]")
    if window is not None and n_batches == 1:
        window.update(batches=batches, deferred=len(deferred),
                      launches=launches,
                      evaluator_ms_per_task=1e3 * sec_per_task)
    elif window is not None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - steady["t0"]
        steady_batches = n_batches - 1
        window.update(batches=batches, deferred=len(deferred),
                      launches=launches,
                      evaluator_ms_per_task=1e3 * sec_per_task,
                      ms_per_task=1e3 * wall / (steady_batches * N_TASK),
                      syncs=(to_host.syncs - steady["syncs0"]) / steady_batches)
        if "prof" in steady:
            steady["prof"].stop()
            busy = sum(_dev_us(e) for e in _device_events(steady["prof"]))
            window["busy_share"] = busy / (wall * 1e6)
        log(f"steady window {label}: {steady_batches} batches, ms_per_task "
            f"{window['ms_per_task']:.4f} host_syncs_per_batch "
            f"{window['syncs']:.2f}" + (
                f" busy_share {window['busy_share']:.4f} (profiled)"
                if "busy_share" in window else ""))
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


def queued_ms(fn, calls=10, runs=5):
    """Median milliseconds a call of ``fn`` takes on the card with the host
    out of the window: a spinning kernel (~2.5 ms) holds the stream while
    the host queues the two events and ``calls`` calls between them, so
    the card runs them back to back however long the host takes to launch
    each."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


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


def steady_batch(root, solver):
    """A zero-shot soft EM-Dirichlet method with ``solver`` and its second
    sampled batch (gathered on the card, as the evaluator's device_gather
    does), after the first one has hosted the compact_first guard and the
    warm-up."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch.core.config import load_full_config
    from transductive_clip_tpu_torch.features.cache import (
        load_feature_cache,
        softmax_cache_path,
    )
    from transductive_clip_tpu_torch.methods import get_zero_shot_method
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
    tasks = []
    for _ in range(2):
        idx = np.stack(list(SamplerQueryZeroShot(sampler)))
        tasks.append({"x_q": feats_dev[torch.as_tensor(idx, device="cuda")],
                      "y_q": labels[idx][..., None]})
    method.run_task(tasks[0])
    return method, tasks[1]


def profile_batch(root, solver):
    """Where one steady-state batch of the zero-shot soft main path spends
    its time: the method's run_task on a steady batch under torch.profiler;
    prints the top kernels by device time, the device's busy share of the
    wall clock, and K1's and the auction's device time and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from transductive_clip_tpu_torch.ops.common import to_host

    method, task = steady_batch(root, solver)
    torch.cuda.synchronize()
    to_host.syncs = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        method.run_task(task)
        wall_us = (time.perf_counter() - t0) * 1e6
    events, _ = _report_profile(f"zero-shot {solver}", prof, wall_us,
                                to_host.syncs)
    k1 = [e for e in events if "dirichlet_row_solve" in e.key]
    auction = [e for e in events if "auction_kernel" in e.key]
    log(f"profile zero-shot {solver}: dirichlet_row_solve (K1) "
        f"{sum(_dev_us(e) for e in k1) / 1e3:.3f} ms of device time in "
        f"{sum(e.count for e in k1)} launches, auction_assign "
        f"{sum(_dev_us(e) for e in auction) / 1e3:.3f} ms in "
        f"{sum(e.count for e in auction)}; host_syncs {to_host.syncs}")


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

    fs = ["shots", str(SHOTS), *BLOCKING]
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
                              row_mask=None, share=None, cs=None):
            out = update_alpha(alpha0, y_cst, iter_mm=iter_mm, solver=solver,
                               row_mask=row_mask, share=share, cs=cs)
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


def _same_batches(label, got, want):
    """Fails unless two runs' batches have equal predictions and
    accuracies, batch for batch."""
    import numpy as np

    if len(got) != len(want):
        fail(f"{label}: {len(got)} batches against {len(want)}")
    for b, ((p, a), (pw, aw)) in enumerate(zip(got, want)):
        if not (np.array_equal(p, pw) and np.array_equal(a, aw)):
            fail(f"{label}: batch {b} differs (predictions equal: "
                 f"{np.array_equal(p, pw)}, accuracies equal: "
                 f"{np.array_equal(a, aw)})")


def run_zero_shot_pipelines(root, counters, records, launches):
    """Phase zero_shot_pipelines: soft EM-Dirichlet with ``pallas`` through
    the CLI on the four routes of ZS_ROUTES, PIPELINE_BATCHES batches each,
    run for the steady window's wall clock and syncs in turns (the routes in
    order, then in reverse: two readings a route) and once more under
    torch.profiler for its busy share; every batch of every run bit-equal
    across the routes; the auction's exhausted-budget fallback forced once
    on the fused route, equal to the host route, each of its 3 batches
    counted as a host fallback; the native LAP loaded.
    Returns the auction's input values of the first device-route batch."""
    import torch

    from transductive_clip_tpu_torch import native
    from transductive_clip_tpu_torch.methods import base as tbase
    from transductive_clip_tpu_torch.ops import cuda_auction

    captured = {}
    proto_rows = tbase._proto_rows_device

    def keep_values(*args, **kwargs):
        out = proto_rows(*args, **kwargs)
        if "values" not in captured:
            captured["values"] = (out[2] * out[3][..., None]).contiguous()
        return out

    solver = ["shots", "0", "method", "em_dirichlet", "dirichlet_solver",
              "pallas"]
    n_tasks = PIPELINE_BATCHES * N_TASK
    with Phase("zero_shot_pipelines"):
        lap = native.solver_in_use()
        log(f"lap_solve: {lap} ({native._lib._name if native._lib else '-'})")
        if lap != "native":
            fail("the native LAP solver did not build or load")
        runs, table = {}, {route: {"ms_per_task_runs": []}
                           for route in ZS_ROUTES}
        order = list(ZS_ROUTES) + list(reversed(ZS_ROUTES))
        for turn, route in enumerate(order):
            window = {}
            tbase._proto_rows_device = (keep_values if route == "blocking_device"
                                        else proto_rows)
            try:
                run_main_path(root, f"zero-shot {route}", solver
                              + ZS_ROUTES[route], n_tasks, counters,
                              window=window)
            finally:
                tbase._proto_rows_device = proto_rows
            if route in runs:
                _same_batches(f"zero-shot {route}, second run",
                              window["batches"], runs[route])
            runs[route] = window["batches"]
            rec = table[route]
            rec["ms_per_task_runs"].append(window["ms_per_task"])
            rec.update(syncs_per_batch=window["syncs"],
                       auction_launches=window["launches"]["auction_assign"],
                       k1_launches=window["launches"]["dirichlet_row_solve"])
            device = route != "blocking_host"
            if device != (rec["auction_launches"] > 0):
                fail(f"zero-shot {route} launched auction_assign "
                     f"{rec['auction_launches']} times")
            if turn >= len(ZS_ROUTES):
                continue
            profiled = {"profile": True}
            run_main_path(root, f"zero-shot {route} profiled", solver
                          + ZS_ROUTES[route], n_tasks, counters,
                          window=profiled)
            rec["busy_share"] = profiled["busy_share"]
        for rec in table.values():
            rec["ms_per_task"] = statistics.mean(rec["ms_per_task_runs"])
        for route in ZS_ROUTES:
            _same_batches(f"zero-shot {route} vs blocking_host", runs[route],
                          runs["blocking_host"])
        log("zero-shot routes, steady window (batches 1-"
            f"{PIPELINE_BATCHES - 1}): " + json.dumps(table))
        launches["auction_assign"] = table["fused_device"]["auction_launches"]
        records["zero_shot_routes"] = table

        assign = cuda_auction.auction_assign
        cuda_auction.auction_assign = lambda values, *a, **kw: torch.full(
            values.shape[:2], -1, dtype=torch.int32, device=values.device)
        try:
            window = {}
            run_main_path(root, "zero-shot fused_device, auction exhausted",
                          solver + ZS_ROUTES["fused_device"], 3 * N_TASK,
                          counters, window=window, host_fallbacks=3)
        finally:
            cuda_auction.auction_assign = assign
        _same_batches("the exhausted auction's fallback vs blocking_host",
                      window["batches"], runs["blocking_host"][:3])
        log("exhausted auction: the fused route's fallback gives the host "
            "route's predictions")
    return captured["values"]


def run_few_shot_pipelines(root, counters):
    """Phase few_shot_pipelines: few-shot EM-Dirichlet soft with ``pallas``
    (three batches) and alpha-TIM with ``tim_grad_impl pallas`` at
    TIM_ITER steps (two), deferred and fused against blocking, batch for
    batch."""
    fs = ["shots", str(SHOTS)]
    cases = (("em_dirichlet", ["dirichlet_solver", "pallas"], 3,
              "dirichlet_row_solve"),
             ("alpha_tim", ["tim_grad_impl", "pallas", "iter", str(TIM_ITER)],
              2, "tim_support_grad"))
    with Phase("few_shot_pipelines"):
        for method, extra, n_batches, kernel in cases:
            runs = {}
            for route, opts in FS_ROUTES.items():
                window = {}
                run_main_path(root, f"few-shot {method} {route}",
                              fs + ["method", method, *extra, *opts],
                              n_batches * N_TASK, counters, window=window)
                if window["launches"][kernel] <= 0:
                    fail(f"few-shot {method} {route} launched {kernel} 0 times")
                runs[route] = window["batches"]
            for route in ("deferred", "fused"):
                _same_batches(f"few-shot {method} {route} vs blocking",
                              runs[route], runs["blocking"])


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run_methods(root, counters, records):
    """Phases zero_shot_methods and few_shot_methods: the k-means family,
    EM-Gaussian (with and without a diagonal precision) and inductive CLIP
    through the CLI on the zero-shot softmax cache, and PADDLE, BD-CSPN and
    LaplacianShot on the 4-shot caches (each its tuned value from the val
    grid), two blocking batches each: accuracy, steady ms per task, auction
    launches (> 0 for the clustering methods, 0 for inductive CLIP) and no
    host-LAP fallback. Then soft k-means and EM-Gaussian-cov on the default
    route (fused, with the auction) and LaplacianShot on the default routes
    (the method declines the pipelines): every batch equal to blocking."""
    from transductive_clip_tpu_torch.eval.few_shot import VAL_PARAM

    auction = 0
    with Phase("zero_shot_methods"):
        log(_smi())
        table, blocking = {}, {}
        for name in ZS_METHODS:
            window = {}
            t0 = time.perf_counter()
            acc, ms, got, syncs = run_main_path(
                root, f"zero-shot {name}",
                ["shots", "0", "method", name, *BLOCKING], 2 * N_TASK,
                counters, window=window, min_accuracy=ACCURACY_FLOOR[name])
            clustering = name != "inductive_clip"
            if clustering != (got["auction_assign"] > 0):
                fail(f"zero-shot {name} launched auction_assign "
                     f"{got['auction_assign']} times")
            auction += got["auction_assign"]
            blocking[name] = window["batches"]
            table[name] = {"accuracy": acc, "ms_per_task": ms,
                           "auction_launches": got["auction_assign"],
                           "host_fallbacks": 0,
                           "host_syncs_per_batch": syncs,
                           "seconds": time.perf_counter() - t0}
        for name in FUSED_CHECKED:
            window = {}
            run_main_path(root, f"zero-shot {name} default route",
                          ["shots", "0", "method", name], 2 * N_TASK,
                          counters, window=window,
                          min_accuracy=ACCURACY_FLOOR[name])
            if window["deferred"] != 1 or window["launches"][
                    "auction_assign"] != 2:
                fail(f"zero-shot {name} default route: {window['deferred']} "
                     "batches deferred, auction launches "
                     f"{window['launches']['auction_assign']}")
            auction += window["launches"]["auction_assign"]
            _same_batches(f"zero-shot {name} fused vs blocking",
                          window["batches"], blocking[name])
        log("zero-shot methods, two blocking batches each: "
            + json.dumps(table))
        records["zero_shot_methods"] = table
    with Phase("few_shot_methods"):
        log(_smi())
        table = {}
        for name in FS_METHODS:
            tuned = {}

            def keep_param(method, logs, name=name):
                key = VAL_PARAM[name.upper()]
                tuned[key] = method.args[key]

            window = {}
            t0 = time.perf_counter()
            acc, ms, got, syncs = run_main_path(
                root, f"few-shot {name}",
                ["shots", str(SHOTS), "method", name, *BLOCKING],
                2 * N_TASK, counters, on_batch=keep_param, window=window,
                min_accuracy=ACCURACY_FLOOR[name])
            table[name] = {"accuracy": acc, "ms_per_task": ms, **tuned,
                           "host_syncs_per_batch": syncs,
                           "seconds": time.perf_counter() - t0}
            if name == "laplacian_shot":
                default = {}
                run_main_path(root, "few-shot laplacian_shot default routes",
                              ["shots", str(SHOTS), "method", name],
                              2 * N_TASK, counters, window=default,
                              min_accuracy=ACCURACY_FLOOR[name])
                if default["deferred"]:
                    fail("few-shot laplacian_shot took a pipeline")
                _same_batches("few-shot laplacian_shot default vs blocking",
                              default["batches"], window["batches"])
        log("few-shot methods, two blocking batches each: "
            + json.dumps(table))
        records["few_shot_methods"] = table
    records["auction_assign"]["methods_launches"] = auction


def write_visual_caches(root, seed):
    """Synthetic ImageNet-shaped visual caches at RN50's width under
    ``root``: test PER_CLASS and train TRAIN_PER_CLASS images a class, each
    its class's unit direction plus noise (VISUAL_NOISE a coordinate),
    L2-normalized, made on the card from ``seed``; the unit directions are
    the text prototypes, written where ``extraction.text_cache_path`` looks."""
    import torch

    from transductive_clip_tpu_torch.core.config import CfgNode
    from transductive_clip_tpu_torch.core.io import save_pickle
    from transductive_clip_tpu_torch.eval.extraction import text_cache_path
    from transductive_clip_tpu_torch.features.cache import (
        save_feature_cache,
        visual_cache_path,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    text = torch.randn(N_CLASS, VISUAL_DIM, generator=g, device="cuda")
    text /= torch.linalg.norm(text, dim=-1, keepdim=True)
    for split, per_class in (("test", PER_CLASS), ("train", TRAIN_PER_CLASS)):
        labels = torch.arange(N_CLASS, device="cuda").repeat_interleave(
            per_class)
        feats = text[labels] + VISUAL_NOISE * torch.randn(
            labels.numel(), VISUAL_DIM, generator=g, device="cuda")
        feats /= torch.linalg.norm(feats, dim=-1, keepdim=True)
        save_feature_cache(
            visual_cache_path("imagenet", split, "RN50", root=root),
            feats.cpu().numpy(), labels.cpu().numpy())
    path = text_cache_path(CfgNode(dict(root=root, dataset="imagenet",
                                        backbone="RN50")))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_pickle(path, {"text_features": text.cpu().numpy()})


def run_visual_methods(root, counters, records):
    """Phase visual_methods: on synthetic visual caches and text prototypes
    (``write_visual_caches``), one blocking batch of each zero-shot method
    with ``use_softmax_feature False`` (EM-Dirichlet must refuse) and of
    PADDLE, BD-CSPN, LaplacianShot and alpha-TIM (TIM_ITER Adam steps);
    every accuracy finite and in (0, 1]."""
    root = os.path.join(root, "visual")
    with Phase("visual_methods"):
        log(_smi())
        write_visual_caches(root, SEED + 2)
        visual = ["use_softmax_feature", "False", *BLOCKING]
        try:
            run_main_path(root, "visual zero-shot em_dirichlet",
                          ["shots", "0", "method", "em_dirichlet", *visual],
                          N_TASK, counters, min_accuracy=0.0)
        except ValueError as e:
            if "simplex" not in str(e):
                raise
            log(f"visual zero-shot em_dirichlet refused: {e}")
        else:
            fail("zero-shot em_dirichlet ran on visual features")
        table = {}
        runs = [("0", name, []) for name in ZS_METHODS]
        runs += [(str(SHOTS), name, []) for name in FS_METHODS]
        runs.append((str(SHOTS), "alpha_tim", ["iter", str(TIM_ITER)]))
        for shots, name, extra in runs:
            acc, ms, got, _ = run_main_path(
                root, f"visual {shots}-shot {name}",
                ["shots", shots, "method", name, *visual, *extra], N_TASK,
                counters, min_accuracy=0.0)
            table[f"{shots}-shot {name}"] = {
                "accuracy": acc, "ms_per_task_first_batch": ms,
                "auction_launches": got["auction_assign"]}
        log("visual-feature methods, one blocking batch each: "
            + json.dumps(table))
        records["visual_methods"] = table


# the first design's times on these cases, taken one call a timed window
# (PERF.md's table of the kernels with no Pallas counterpart, H100 80GB
# HBM3 at 700 W): quoted in the log beside this run's times, never recorded
AUCTION_FIRST_DESIGN_MS = {"zero-shot batch": 1.1352, "random": 0.1172,
                  "5 x 5 on a 0.25 grid": 21.5540}


def auction_cases():
    """auction_vs_plain's cases besides the zero-shot batch's values, as
    (name, values on the card, max_iters, timed): random values, the edges
    of the kernel (C = 1, R = 1, R = C, C not a multiple of 4), rows the
    kernel groups and rows it must not (repeated non-zero rows, rows one
    ulp apart, rows of -0.0 beside rows of +0.0, many distinct rows at
    C = 2000), the quantised 5 x 5 price wars and a budget run out."""
    import numpy as np
    import torch

    def uniform(seed, *shape):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.rand(*shape, generator=g, device="cuda")

    zeros = uniform(4, 8, N_QUERY, N_CLASS)
    zeros[:, 10:] = 0.0                 # absent clusters: rows of zeros
    # the cases of rows the kernel groups, made with numpy so that their
    # rounds are known (price wars of ~1e3 rounds at most: the plain version
    # runs the whole batch's rounds)
    def draw(seed, *shape):
        return np.random.default_rng(seed).uniform(
            0, 1, size=shape).astype(np.float32)

    signed = draw(20, 8, 24, 97)
    signed[:, 3:] = 0.0
    signed[:, 3::2] = -0.0
    repeated = draw(21, 16, 30, N_CLASS)
    repeated[:, 12:24] = repeated[:, :12]
    repeated97 = np.round(draw(22, 16, 6, 97) * 4) / 4
    repeated97[:, 1::3] = repeated97[:, :1]
    ulp = np.repeat(draw(23, 16, 3, 64), 2, axis=1)
    ulp[:, 1::2] = np.nextafter(ulp[:, 1::2], np.float32(2))
    wide = draw(24, 8, 40, 2000)
    wide[:, 30:] = wide[:, :10]
    signed, repeated, repeated97, ulp, wide = (
        torch.as_tensor(a, device="cuda")
        for a in (signed, repeated, repeated97, ulp, wide))
    wars = np.random.default_rng(0).uniform(0, 1, size=(125, 5, 5))
    wars = torch.as_tensor(np.round(wars.astype(np.float32) * 4) / 4).to(
        zeros.device)
    return (("random", uniform(1, N_TASK, N_QUERY, N_CLASS), 200_000, True),
            ("C = 1", uniform(2, 16, 1, 1), 200_000, False),
            ("C = 1, R = 3", uniform(3, 16, 3, 1), 64, False),
            ("R = 1", uniform(5, 16, 1, N_CLASS), 200_000, False),
            ("R = C", uniform(6, 16, N_QUERY, N_QUERY), 200_000, False),
            ("C = 63", uniform(7, 16, 30, 63), 200_000, False),
            ("rows of zeros", zeros, 200_000, False),
            ("rows of -0.0 and +0.0", signed, 200_000, False),
            ("repeated rows", repeated, 200_000, False),
            ("repeated rows, C = 97, a 0.25 grid", repeated97, 200_000,
             False),
            ("rows one ulp apart", ulp, 200_000, False),
            ("many distinct rows, C = 2000", wide, 200_000, False),
            ("5 x 5 on a 0.25 grid", wars, 200_000, True),
            ("budget run out", uniform(8, N_TASK, N_QUERY, N_CLASS), 2,
             False))


def run_auction_checks(records, zero_shot_values):
    """Phase auction_vs_plain: the auction kernel against its plain version,
    col4row, rounds and scans (the rows it scanned: one a group of bit-equal
    rows with an unassigned row, a round) equal, on a zero-shot batch's
    values and on auction_cases(); ms and rounds of each case (ten calls a
    timed window, and one, as the first design was timed, whose figure the
    log quotes beside), and on the zero-shot batch the ms a round (the
    batch at max_iters 1 and in full, each queued behind a spinning kernel,
    the difference over the rounds between).
    The timed cases carry the bound counted the guide's way (``bound_ms``:
    the values read once and col4row written once at the HBM rate, 2 x
    scans x C fp32 operations); the log adds the first design's figure with
    every bid's row read again (``bound_rereads_ms``)."""
    import torch

    from transductive_clip_tpu_torch.ops import cuda_auction as cau
    from transductive_clip_tpu_torch.ops.auction import (
        auction_assign_reference,
    )

    cases = (("zero-shot batch", zero_shot_values, 200_000, True),
             *auction_cases())
    with Phase("auction_vs_plain"):
        log(_smi())
        rec = None
        for name, values, max_iters, timed in cases:
            shape = list(values.shape)
            got, rounds, scans = cau.auction_assign(
                values, max_iters=max_iters, return_rounds=True,
                return_scans=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, want_rounds, bids, want_scans = auction_assign_reference(
                values, max_iters=max_iters, return_rounds=True,
                return_bids=True, return_scans=True)
            torch.cuda.synchronize()
            plain_once_ms = 1e3 * (time.perf_counter() - t0)
            if not (torch.equal(got, want)
                    and torch.equal(rounds.long(), want_rounds)
                    and torch.equal(scans.long(), want_scans)):
                fail(f"auction_assign {name} {shape}: col4row, rounds or "
                     "scans differ from the plain version's")
            # ten calls queued a timed window (the price wars one): the
            # kernel's time, not the host's launch; one call a window too,
            # as the first design was timed
            kernel_ms = time_ms(lambda: cau.auction_assign(
                values, max_iters=max_iters),
                inner=1 if values.shape[2] == 5 else 10)
            one_call_ms = time_ms(lambda: cau.auction_assign(
                values, max_iters=max_iters)) if timed else None
            rounds_mean = rounds.float().mean().item()
            scans_mean = scans.float().mean().item()
            line = (f"auction_assign {name} {shape}: col4row, rounds and "
                    f"scans equal, rounds max {int(rounds.max())} mean "
                    f"{rounds_mean:.2f}, scans a task {scans_mean:.2f} "
                    f"(bids {bids.float().mean().item():.2f}), unassigned "
                    f"{int((got < 0).sum())}, ms {kernel_ms:.4f}"
                    + (f" (one call a window {one_call_ms:.4f}, the first "
                       "design's so, quoted from PERF.md: "
                       f"{AUCTION_FIRST_DESIGN_MS[name]:.4f})"
                       if name in AUCTION_FIRST_DESIGN_MS else "")
                    + f", the plain version's one call {plain_once_ms:.3f} ms")
            if name == "zero-shot batch" and not (
                    scans_mean <= shape[1] + rounds_mean):
                fail(f"auction_assign zero-shot batch: {scans_mean} scans a "
                     f"task, more than R + rounds ({shape[1]} + "
                     f"{rounds_mean})")
            if timed:
                n_bids, n_scans = int(bids.sum()), int(scans.sum())
                n, r, c = shape
                # the plain version's price wars take seconds a call: one
                # call, host clock; the others CUDA events, median of 3
                plain_ms = plain_once_ms if c == 5 else time_ms(
                    lambda: auction_assign_reference(
                        values, max_iters=max_iters), runs=3)
                one = {"ms": kernel_ms, "plain_ms": plain_ms,
                       "ms_one_call": one_call_ms,
                       "rounds_max": int(rounds.max()),
                       "rounds_mean": rounds_mean, "bids": n_bids,
                       "scans": n_scans, "max_abs_err": 0.0,
                       # values read once, col4row written once; a subtract
                       # and a compare an element of every scanned row
                       **_bound(2 * n_scans * c, 4 * n * r * c + 4 * n * r,
                                PEAK_FP32_S)}
                # the first design's figure, every bid's row read: logged,
                # not a bound of this kernel
                rereads_ms = 4 * n_bids * c / PEAK_BYTES_S * 1e3
                line += (f"; plain_ms {one['plain_ms']:.4f} bound_ms "
                         f"{one['bound_ms']:.6f} ({one['bound_by']}: the "
                         f"values once, {n_scans} scans of {c} columns) "
                         f"bound_rereads_ms {rereads_ms:.6f} "
                         f"({n_bids} bids' rows)")
                if name == "zero-shot batch":
                    # a round's time: the launch in full less the launch
                    # that stops after its first round, each queued behind
                    # a spinning kernel (a launch of the first round alone
                    # is shorter than the host's work between two calls)
                    full_ms, first_ms = (queued_ms(
                        lambda: cau.auction_assign(values, max_iters=m))
                        for m in (max_iters, 1))
                    between = max(int(rounds.max()) - 1, 1)
                    one.update(ms_first_round=first_ms,
                               ms_per_round=(full_ms - first_ms) / between)
                    line += (f"; queued behind a spin: in full "
                             f"{full_ms:.4f} ms, "
                             f"max_iters 1 {first_ms:.4f} ms, so "
                             f"{1e3 * one['ms_per_round']:.3f} us a round "
                             f"over the {between} rounds after the first of "
                             "the slowest task")
                if rec is None:
                    rec = dict(one, library_ms=None, cases={})
                rec["cases"][name] = one
            log(line)
        records["auction_assign"] = rec


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
    bound (the three convolutions' operations; x, out and weight bytes) and
    the weight bytes the blocks read from L2 (each of the B x strips blocks
    reads the three weight matrices once: counted, not measured)."""
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
        strips = -(-h // cb.strip_rows(h, w, c, c_mid, dtype))
        weights = sum(a.numel() * a.element_size()
                      for a in (args[1], args[3], args[5]))
        out.update(ms=time_ms(lambda: cb.fused_identity_bottleneck(*args)),
                   plain_ms=time_ms(
                       lambda: cb.fused_identity_bottleneck_reference(*args)),
                   l2_weight_bytes=b * strips * weights,
                   **_bound(ops, nbytes, peak))
        log(f"{name}: ms {out['ms']:.4f} plain_ms {out['plain_ms']:.4f} "
            f"bound_ms {out['bound_ms']:.4f} ({out['bound_by']}: "
            f"{ops:.4e} ops, {nbytes:.4e} bytes) weights from L2 "
            f"{out['l2_weight_bytes']:.4e} bytes ({b} x {strips} blocks)")
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
        # one record for a batch (bf16: 512 images, fp32: 64 and 512): the
        # sums over its 12 launches (2, 3, 5 and 2 at the four stages' shapes)
        def batch_record(batch, dtype, seed_add):
            rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "per_shape": []}
            ops_bound = 0.0
            for (h, w, c), c_mid, count in RN50_IDENTITY:
                one = check_bottleneck(batch, h, w, c, c_mid, dtype,
                                       h + seed_add, True)
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         one["max_abs_err"])
                for key in ("ms", "plain_ms", "bound_ms"):
                    rec[key] += count * one[key]
                if one["bound_by"] == "operations":
                    ops_bound += count * one["bound_ms"]
                rec["per_shape"].append({"shape": [batch, h, w, c, c_mid],
                                         "launches_a_batch": count, **one})
            rec["bound_by"] = ("operations" if ops_bound >= rec["bound_ms"] / 2
                               else "bytes")
            log(f"fused_identity_bottleneck {str(dtype)[6:]}, a batch of "
                f"{batch} (12 launches): ms {rec['ms']:.4f} plain_ms "
                f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.4f}")
            return rec

        rec = batch_record(EXTRACT_BATCH, bf16, 0)
        rec["fp32"] = batch_record(F32_BATCH, fp32, 1)
        # the fp32 row's headline: [64, 14, 14, 1024] / 256
        rec["fp32"]["layer3"] = rec["fp32"]["per_shape"][2]
        rec["fp32"]["batch_512"] = batch_record(EXTRACT_BATCH, fp32, 2)
        errs = [rec["max_abs_err"], rec["fp32"]["max_abs_err"],
                rec["fp32"]["batch_512"]["max_abs_err"]]
        for seed, shape in enumerate(K5_EDGES, start=4):
            for dtype in (bf16, fp32):
                # the gate takes every one of these shapes in both dtypes
                # (fp32's [5, 100, 16] / 72 in strips of one row)
                if not cb.fused_bottleneck_supported(*shape[1:], dtype):
                    fail(f"K5 gate refuses {shape} {dtype}")
                errs.append(check_bottleneck(*shape, dtype, seed,
                                             False)["max_abs_err"])
        for seed, shape in enumerate(K5_EDGES_F32, start=10):
            errs.append(check_bottleneck(*shape, fp32, seed,
                                         False)["max_abs_err"])
        rec["max_abs_err"] = max(errs)
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


def zero_shot_visual_rn50(model, root, dataset_path, counters, records):
    """Phase zero_shot_visual_rn50: one CLI call, ``method soft_kmeans
    use_softmax_feature False`` on the EuroSAT split with the loaded RN50
    bf16 model (``fused_resnet=True``): the evaluator extracts the test
    split's visual cache (pixels made on the card from the seed, in place
    of the decoded images; K5 12 launches a batch) and evaluates it (the
    text prototypes from the cache the extraction phase wrote) to its TSV
    row, written under ``root``."""
    import numpy as np

    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch import data as tdata
    from transductive_clip_tpu_torch.features.cache import (
        load_feature_cache,
        visual_cache_path,
    )
    from transductive_clip_tpu_torch.methods.base import note_host_fallback

    def pixels(items, preprocess=None, batch_size=EXTRACT_BATCH):
        labels = np.array([d.label for d in items], np.int64)
        return pixel_batches(labels, 224, batch_size, SEED + 3)

    with Phase("zero_shot_visual_rn50"):
        log(_smi())
        for wrapper in counters.values():
            wrapper.launches = 0
        note_host_fallback.count = 0
        load, batches = cli.maybe_load_clip, tdata.iter_image_batches
        cli.maybe_load_clip = lambda args, device=None: (model, None)
        tdata.iter_image_batches = pixels
        os.chdir(root)
        t0 = time.perf_counter()
        try:
            acc, sec_per_task = cli.main(
                ["--config-root", os.path.join(HERE, "config"), "--opts",
                 "dataset", "eurosat", "method", "soft_kmeans", "shots", "0",
                 "use_softmax_feature", "False", "backbone", "RN50",
                 "root", root, "dataset_path", dataset_path,
                 "number_tasks", str(N_TASK), "batch_size", str(N_TASK),
                 "save_results", "True",
                 "log_path", os.path.join(root, "logs")])
        finally:
            os.chdir(HERE)
            cli.maybe_load_clip, tdata.iter_image_batches = load, batches
        seconds = time.perf_counter() - t0
        got = {name: w.launches for name, w in counters.items()}
        feats, _ = load_feature_cache(visual_cache_path(
            "eurosat", "test", "RN50", root=root))
        with open(os.path.join(root, "results_zero_shot", "test", "eurosat",
                               "SOFT_KMEANS_visual_0shot.txt")) as f:
            row = f.read().strip().splitlines()[-1]
        log(f"zero-shot soft_kmeans, visual features from pixels (random "
            f"RN50 weights): accuracy {acc:.6f} ms_per_task "
            f"{1e3 * sec_per_task:.4f} seconds {seconds:.3f} launches {got} "
            f"cache {feats.shape} TSV row {row!r}")
        n_batches = -(-EUROSAT_TEST // EXTRACT_BATCH)
        if got["fused_identity_bottleneck"] != 12 * n_batches:
            fail(f"the visual RN50 extraction launched K5 "
                 f"{got['fused_identity_bottleneck']} times, not "
                 f"{12 * n_batches}")
        if feats.shape != (EUROSAT_TEST, VISUAL_DIM) or not (
                np.isfinite(feats).all()):
            fail(f"RN50 visual cache: shape {feats.shape} or not finite")
        if not 0.0 <= acc <= 1.0:
            fail(f"zero-shot soft_kmeans on visual features: accuracy {acc}")
        if note_host_fallback.count:
            fail(f"zero-shot soft_kmeans on visual features: "
                 f"{note_host_fallback.count} batches solved their matching "
                 "on the host")
        records["fused_identity_bottleneck"]["visual_path_launches"] = got[
            "fused_identity_bottleneck"]


def run_extraction(root, counters, records, launches):
    """Phases extraction_rn50 (with zero_shot_visual_rn50),
    extraction_rn50_fp32, zero_shot_eval_rn50_cache and
    extraction_vitl336_fp32."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.core.config import CfgNode
    from transductive_clip_tpu_torch.data import build_dataset
    from transductive_clip_tpu_torch.features.cache import load_feature_cache
    from transductive_clip_tpu_torch.methods.base import note_host_fallback
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
        del first
        zero_shot_visual_rn50(model, root, dataset_path, counters, records)
        del model
        torch.cuda.empty_cache()
    with Phase("extraction_rn50_fp32"):
        # the same checkpoint under float32: K5's fp32 kernel on the 12
        # identity blocks; its own cache root, so the zero-shot phase below
        # reads the bf16 cache of the whole split
        model, _ = load("RN50", compute_dtype=torch.float32,
                        fused_resnet=True)
        model.fused_blocks = [b for b in model.module.visual.blocks()
                              if b.fuse]
        log(f"RN50 fp32: {model.compute_dtype} attention "
            f"{model.attention_impl} fold_bn {model.fold_bn} fused blocks "
            f"{len(model.fused_blocks)}")
        args = CfgNode(dict(dataset="eurosat", backbone="RN50",
                            root=os.path.join(root, "rn50_fp32"),
                            dataset_path=dataset_path))
        items = dataset.test[::VIT_EVERY]
        path, got, n_batches, first = extract(
            "RN50 fp32", model, args, dataset, items, 224, F32_BATCH,
            counters)
        if (got["fused_identity_bottleneck"] != 12 * n_batches
                or got["attention_rows"] != 12
                or got["attention_blocked"] != 0):
            fail(f"RN50 fp32 extraction launched {got}, not K5 12 a batch "
                 f"({12 * n_batches}) and K4a 12 (one text batch)")
        records["fused_identity_bottleneck"]["fp32_path_launches"] = got[
            "fused_identity_bottleneck"]
        feats, _ = load_feature_cache(path)
        if feats.shape != (len(items), len(EUROSAT_CLASSES)) or not (
                np.isfinite(feats).all()
                and np.allclose(feats.sum(-1), 1.0, atol=1e-4)):
            fail(f"RN50 fp32 softmax cache: shape {feats.shape} or not "
                 "simplex rows")
        compare_routes("RN50 fp32", model, first, prompts, counters)
        time_routes("RN50 fp32", model, first)
        # and at extract_batch_size's default, as an fp32 extraction runs
        big = next(pixel_batches(np.zeros(EXTRACT_BATCH, np.int64), 224,
                                 EXTRACT_BATCH, SEED))[0]
        time_routes("RN50 fp32", model, big)
        del model, first, big
        torch.cuda.empty_cache()
    with Phase("zero_shot_eval_rn50_cache"):
        note_host_fallback.count = 0
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
        if note_host_fallback.count:
            fail(f"zero-shot on the RN50 cache: {note_host_fallback.count} "
                 "batches solved their matching on the host after the "
                 "device auction ran out of rounds")
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

def _tp_zero_shot_batch(root, solver, method="em_dirichlet"):
    """(args, the whole task dict) of one zero-shot batch of ``method`` at
    the protocol (N_TASK tasks x N_QUERY queries x K = N_CLASS) drawn from
    the synthetic test cache by the evaluator's sampler with SEED: the same
    batch in every process that asks."""
    import numpy as np

    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.features.cache import (
        load_feature_cache,
        softmax_cache_path,
    )
    from transductive_clip_tpu_torch.tasks import (
        CategoriesSamplerZeroShot,
        SamplerQueryZeroShot,
    )

    args = cli.parse_args([
        "--config-root", os.path.join(HERE, "config"), "--opts", "dataset",
        "imagenet", "shots", "0", "method", method,
        "dirichlet_solver", solver, "n_query", str(N_QUERY), "batch_size",
        str(N_TASK), "root", root, "matching_backend", "device"])
    feats, labels = load_feature_cache(softmax_cache_path(
        "imagenet", "test", args.backbone, args.T, root=root))
    sampler = CategoriesSamplerZeroShot(
        N_TASK, args.k_eff, args.n_class, N_QUERY, force_query_size=True,
        rng=np.random.default_rng(SEED))
    sampler.create_list_classes(labels)
    idx = np.stack(list(SamplerQueryZeroShot(sampler)))
    return args, {"x_q": feats[idx], "y_q": labels[idx][..., None]}


def _tp_extraction_inputs(root, dataset_path):
    """(model args, dataset, labels) of the two-rank extraction: the first
    TP_IMAGES images of the EuroSAT-shaped split."""
    import numpy as np

    from transductive_clip_tpu_torch.core.config import CfgNode
    from transductive_clip_tpu_torch.data import build_dataset

    dataset = build_dataset("eurosat", dataset_path)
    labels = np.array([d.label for d in dataset.test[:TP_IMAGES]], np.int64)
    return (CfgNode(dict(dataset="eurosat", backbone="RN50", root=root,
                         dataset_path=dataset_path)), dataset, labels)


def _kernel_counters():
    """name -> wrapper of every kernel (each counts its launches)."""
    from transductive_clip_tpu_torch.ops import cuda_attention as ca
    from transductive_clip_tpu_torch.ops import cuda_auction as cau
    from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb
    from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd
    from transductive_clip_tpu_torch.ops import cuda_tim as ct

    return {"dirichlet_row_solve": cd.dirichlet_row_solve,
            "mm_row_solve": cd.mm_row_solve,
            "tim_support_grad": ct.tim_support_grad,
            "attention_rows": ca.attention_rows,
            "attention_blocked": ca.attention_blocked,
            "fused_identity_bottleneck": cb.fused_identity_bottleneck,
            "auction_assign": cau.auction_assign}


def _tp_nccl_probe(group):
    """One NCCL all-reduce between two ranks that share a card: "ok", or
    the error NCCL raised, returned so that the parent can log it and run
    the group on gloo instead."""
    import torch
    import torch.distributed as dist

    try:
        t = torch.ones(1, device=group.device)
        dist.all_reduce(t, group=group.pg)
        torch.cuda.synchronize(group.device)
        return "ok" if t.item() == group.world else f"sum {t.item()}"
    except RuntimeError as e:   # DistBackendError is one
        return f"{type(e).__name__}: {e}"


def _tp_two_ranks(group, root, dataset_path):
    """One rank of phase task_parallel_two_ranks (both on cuda:0): every
    kernel count set to 0, then one zero-shot batch of soft EM-Dirichlet
    with 'pallas' and with 'auto' through the method's run_task on this
    rank's half of the tasks, then RN50 bf16 extraction over TP_IMAGES
    images, each rank encoding its half of every batch of EXTRACT_BATCH,
    rank 0 writing the T = 30 softmax cache. Rank 0 returns the whole
    batches' predictions, accuracies and times, the cache's path and the
    launches summed over both ranks."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch.eval.extraction import (
        extract_to_caches,
        get_text_features,
    )
    from transductive_clip_tpu_torch.features.cache import softmax_cache_path
    from transductive_clip_tpu_torch.methods import get_zero_shot_method
    from transductive_clip_tpu_torch.models.clip import load
    from transductive_clip_tpu_torch.parallel import (
        barrier,
        gather_host,
        shard_task_batch,
    )

    counters = _kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    out = {}
    for solver in ("pallas", "auto"):
        args, batch = _tp_zero_shot_batch(root, solver)
        method = get_zero_shot_method(args.name_method, device=group.device,
                                      args=args).set_task_group(group)
        logs = method.run_task(shard_task_batch(batch, group))
        out[solver] = (logs["preds"], logs["acc"], logs["timestamps"])
    args, dataset, labels = _tp_extraction_inputs(
        os.path.join(root, "tp_ranks"), dataset_path)
    model, _ = load("RN50", fused_resnet=True, device=group.device)
    model.set_task_group(group)
    torch.cuda.synchronize(group.device)
    t0 = time.perf_counter()
    text = get_text_features(args, model, dataset.classnames,
                             dataset.template, group=group)
    path = softmax_cache_path("eurosat", "test", "RN50", 30, root=args.root)
    emb, _ = extract_to_caches(
        model, pixel_batches(labels, 224, EXTRACT_BATCH, SEED), [(30, path)],
        text, write=group.rank == 0)
    seconds = time.perf_counter() - t0
    barrier(group)
    launches = {name: w.launches for name, w in counters.items()}
    every = gather_host(launches, group)
    out.update(path=path, seconds=seconds, finite=bool(np.isfinite(emb).all()),
               launches={name: sum(r[name] for r in every)
                         for name in launches})
    return out


def run_task_parallel(root, counters, records):
    """Phases task_parallel_world1 and task_parallel_two_ranks: the port's
    task data parallelism (parallel/) on the card.

    World 1: an NCCL group of one rank in this process; soft EM-Dirichlet
    with 'pallas' (K1) and 'auto' ('minka': its criterion gathered over the
    group at every Newton step), TP_BATCHES batches each on the blocking
    and the fused route (the auction), hard 'mm_pallas' (K2) and alpha-TIM
    'pallas' fp32 (K3, TIM_ITER steps) one batch each, all through the CLI
    (``cli.run`` with the group), each held batch for batch against the
    same run without a group (predictions and accuracies equal), with both
    runs' ms per task and the group's collectives per batch. Two ranks on
    this one card (spawned; NCCL first, gloo where NCCL refuses, its
    message logged): one zero-shot batch of 'pallas' and of 'auto', half
    the tasks a rank, equal to the single-process batch; then RN50 bf16
    extraction (K5, K4a) over TP_IMAGES images, half of every batch a rank,
    its softmax cache's top-1 labels equal to the single-process cache's
    (a run whose batches are the ranks' halves, so the towers run at one
    shape in both) and its values within FEATURE_LIMIT["RN50"]. Every
    kernel count is set to 0 before each run; the kernels launched in the
    group runs are recorded as ``task_parallel_launches``."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch.eval.extraction import (
        extract_to_caches,
        get_text_features,
    )
    from transductive_clip_tpu_torch.features.cache import (
        load_feature_cache,
        softmax_cache_path,
    )
    from transductive_clip_tpu_torch.methods import get_zero_shot_method
    from transductive_clip_tpu_torch.models.clip import load
    from transductive_clip_tpu_torch.parallel import (
        destroy_task_group,
        make_task_group,
        spawn_ranks,
    )
    from transductive_clip_tpu_torch.parallel import task_parallel as tp

    dp_launches = {name: 0 for name in counters}
    zs = ["shots", "0", "method", "em_dirichlet"]
    runs = [(f"em_dirichlet {solver} {route}",
             zs + ZS_ROUTES[route + "_device"] + ["dirichlet_solver", solver],
             TP_BATCHES * N_TASK)
            for solver in ("pallas", "auto") for route in ("blocking", "fused")]
    runs += [("hard_em_dirichlet mm_pallas", ["shots", "0", "method",
              "hard_em_dirichlet", "dirichlet_solver", "mm_pallas",
              *BLOCKING], N_TASK),
             ("alpha_tim pallas", ["shots", str(SHOTS), "method", "alpha_tim",
              "tim_grad_impl", "pallas", "iter", str(TIM_ITER), *BLOCKING],
              N_TASK)]
    with Phase("task_parallel_world1"):
        group = make_task_group(0, 1, os.path.join(root, "tp_store"),
                                device="cuda:0")
        log(f"task group: world 1, backend "
            f"{torch.distributed.get_backend(group.pg)} on {group.device}")
        try:
            for label, opts, n in runs:
                alone, grouped = {}, {}
                run_main_path(root, label + " no group", opts, n, counters,
                              window=alone)
                calls = tp.all_reduce.calls + tp.gather_host.calls
                run_main_path(root, label + " world 1",
                              opts + ["data_parallel", "True"], n, counters,
                              window=grouped, group=group)
                calls = tp.all_reduce.calls + tp.gather_host.calls - calls
                _same_batches(f"task_parallel {label}", grouped["batches"],
                              alone["batches"])
                for name, got in grouped["launches"].items():
                    dp_launches[name] += got
                log(f"task_parallel {label}: batches equal; ms_per_task "
                    f"{alone['evaluator_ms_per_task']:.4f} without a group, "
                    f"{grouped['evaluator_ms_per_task']:.4f} in a group of "
                    f"1; collectives per batch {calls / (n // N_TASK):.1f}")
        finally:
            destroy_task_group(group)
        for name in ("dirichlet_row_solve", "mm_row_solve",
                     "tim_support_grad", "auction_assign"):
            if dp_launches[name] <= 0:
                fail(f"the world-1 group runs launched {name} 0 times")
        torch.cuda.empty_cache()

    with Phase("task_parallel_two_ranks"):
        dataset_path = os.path.join(root, "eurosat")
        try:
            nccl = spawn_ranks(_tp_nccl_probe, 2, device="cuda:0",
                               backend="nccl", timeout=180)
        except (RuntimeError, TimeoutError) as e:
            # NCCL's refusal is expected with two ranks on one card: the
            # group then runs on gloo (the ranks' output above has it)
            nccl = f"{type(e).__name__}: {e}"
        backend = "nccl" if nccl == "ok" else "gloo"
        log(f"two ranks on one card: NCCL {nccl!r}; the group runs on "
            f"{backend}")
        got = spawn_ranks(_tp_two_ranks, 2, (root, dataset_path),
                          device="cuda:0", backend=backend, timeout=900)
        for solver in ("pallas", "auto"):
            args, batch = _tp_zero_shot_batch(root, solver)
            logs = get_zero_shot_method(args.name_method, args=args).run_task(
                batch)
            preds, acc, sec = got[solver]
            if not (np.array_equal(preds, logs["preds"])
                    and np.array_equal(acc, logs["acc"])):
                fail(f"task_parallel two ranks {solver}: the batch differs "
                     "from the single-process batch")
            log(f"task_parallel two ranks em_dirichlet {solver}: batch equal "
                f"(accuracy {acc.mean():.6f}); ms_per_task {1e3 * sec:.4f} "
                f"on 2 ranks sharing the card (first batch), "
                f"{1e3 * logs['timestamps']:.4f} alone (first batch)")
        args, dataset, labels = _tp_extraction_inputs(
            os.path.join(root, "tp_single"), dataset_path)
        model, _ = load("RN50", fused_resnet=True)
        text = get_text_features(args, model, dataset.classnames,
                                 dataset.template)
        path = softmax_cache_path("eurosat", "test", "RN50", 30,
                                  root=args.root)

        def halves(batches):
            for images, y in batches:
                half = len(y) // 2
                yield images[:half], y[:half]
                yield images[half:], y[half:]

        extract_to_caches(model, halves(pixel_batches(
            labels, 224, EXTRACT_BATCH, SEED)), [(30, path)], text)
        del model
        single, _ = load_feature_cache(path)
        ranks, ranks_labels = load_feature_cache(got["path"])
        diff = float(np.abs(ranks - single).max())
        top1 = (ranks.argmax(-1) == single.argmax(-1)).mean()
        log(f"task_parallel two ranks RN50 extraction: {len(labels)} images "
            f"{got['seconds']:.3f} s; top-1 agreement {top1:.6f}, max abs "
            f"difference {diff:.3e} against the single-process cache; "
            f"launches {got['launches']}")
        if not (got["finite"] and top1 == 1.0
                and np.array_equal(ranks_labels, labels)
                and diff <= FEATURE_LIMIT["RN50"]):
            fail("task_parallel two-rank extraction differs from the "
                 "single-process cache")
        for name, n in got["launches"].items():
            dp_launches[name] += n
        for name in ("dirichlet_row_solve", "auction_assign",
                     "fused_identity_bottleneck", "attention_rows"):
            if got["launches"][name] <= 0:
                fail(f"the two-rank runs launched {name} 0 times")
        torch.cuda.empty_cache()
    for name, n in dp_launches.items():
        records[name]["task_parallel_launches"] = n
    log(f"task_parallel launches {dp_launches}")


def _class_tp_cases(root, device):
    """(label, method on ``device``, task dict) of every run of phase
    class_tp_two_ranks, the same in every process: one zero-shot batch of
    soft EM-Dirichlet 'pallas' (K1 on the compact rows' shards, the
    compact_first guard included) and of hard 'mm_pallas' (K2, at full
    width on iteration 1), at the protocol; CLASS_TP_FS_TASKS few-shot
    tasks at the 4-shot width (K = d = N_CLASS, SHOTS x N_CLASS support
    rows, N_QUERY queries, drawn with SEED) through few-shot EM-Dirichlet
    'pallas' and TIM_ITER_DEFAULT Adam steps of alpha-TIM (autodiff: tp
    turns 'pallas' off, so the single run takes autodiff too)."""
    import numpy as np

    from transductive_clip_tpu_torch import cli
    from transductive_clip_tpu_torch.methods import (
        get_few_shot_method,
        get_zero_shot_method,
    )
    from transductive_clip_tpu_torch.utils.synthetic import (
        make_few_shot_tasks,
    )

    for method, solver in (("em_dirichlet", "pallas"),
                           ("hard_em_dirichlet", "mm_pallas")):
        args, batch = _tp_zero_shot_batch(root, solver, method)
        yield (f"zero-shot {method} {solver}",
               get_zero_shot_method(args.name_method, device=device,
                                    args=args), batch)
    xs, ys, xq, yq = make_few_shot_tasks(
        np.random.default_rng(SEED), CLASS_TP_FS_TASKS, N_QUERY, N_CLASS,
        SHOTS)
    batch = {"x_s": xs, "y_s": ys, "x_q": xq, "y_q": yq}
    for opts in (["method", "em_dirichlet", "dirichlet_solver", "pallas"],
                 ["method", "alpha_tim", "tim_grad_impl", "autodiff",
                  "iter", str(TIM_ITER_DEFAULT)]):
        args = cli.parse_args([
            "--config-root", os.path.join(HERE, "config"), "--opts",
            "dataset", "imagenet", "shots", str(SHOTS), "n_query",
            str(N_QUERY), "batch_size", str(CLASS_TP_FS_TASKS), *opts])
        yield (f"few-shot {' '.join(opts[1::2][:2])}",
               get_few_shot_method(args.name_method, device=device,
                                   args=args), batch)


def _class_tp_run(method, batch, device):
    """One blocking ``run_task`` of ``method`` on ``batch``, with u kept:
    (logs, u on the host, peak bytes the run allocated on the card, the
    collectives it issued and the bytes its all-reduces moved)."""
    import torch

    from transductive_clip_tpu_torch.parallel import task_parallel as tp

    infer = method._infer

    def kept(task):
        out = infer(task)
        kept.u = out[0]
        return out

    method._infer = kept
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    calls = tp.all_reduce.calls + tp.gather_host.calls
    nbytes = tp.all_reduce.bytes
    logs = method.run_task(batch)
    u = kept.u.cpu().numpy()
    peak = torch.cuda.max_memory_allocated(device) - base
    return (logs, u, peak, tp.all_reduce.calls + tp.gather_host.calls - calls,
            tp.all_reduce.bytes - nbytes)


def _class_tp_rank(group, root):
    """One rank of phase class_tp_two_ranks (dp 1 x tp 2, both on cuda:0):
    every kernel count set to 0, then every run of ``_class_tp_cases`` on
    this rank's half of the classes. Rank 0 returns each run's predictions,
    accuracies, criterions, u, ms per task, collectives and bytes, every
    rank's peak bytes, and the kernels' launches summed over both ranks."""
    from transductive_clip_tpu_torch.parallel import (
        class_layout,
        gather_host,
        shard_task_batch,
    )

    group = class_layout(group, 2)
    counters = _kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    out = {}
    for label, method, batch in _class_tp_cases(root, group.device):
        logs, u, peak, calls, nbytes = _class_tp_run(
            method.set_task_group(group), shard_task_batch(batch, group),
            group.device)
        out[label] = dict(preds=logs["preds"], acc=logs["acc"],
                          crit=logs["criterions"], u=u,
                          ms=1e3 * logs["timestamps"], calls=calls,
                          bytes=nbytes,
                          peak=gather_host(peak, group, world=True))
    every = gather_host({name: w.launches for name, w in counters.items()},
                        group, world=True)
    out["launches"] = {name: sum(r[name] for r in every) for name in counters}
    return out if group.rank == 0 else None


def run_class_tp(root, records):
    """Phase class_tp_two_ranks: class-axis tensor parallelism on the card.
    Two ranks spawned on this one card (gloo: NCCL refuses two ranks a
    card, phase task_parallel_two_ranks), laid out as dp 1 x tp 2, so that
    each holds half of every task's cluster rows (alpha [N, K/2, K]) or
    class weights; every run of ``_class_tp_cases`` is held batch for batch
    against the same batch in this process: predictions and accuracies
    equal, u within 1e-6 of it (tests/test_torch_class_tp.py's limit against
    one process) and the criterions within rtol 2e-3 / atol 1e-5 (the
    class group sums a task's partial sums in another order). Logs each run's collectives and the bytes they
    move, every rank's peak card memory beside this process's, and the ms
    per task of a first batch on a card the ranks share (no claim). The
    kernels launched in the group runs are ``class_tp_launches``."""
    import numpy as np
    import torch

    from transductive_clip_tpu_torch.parallel import spawn_ranks

    with Phase("class_tp_two_ranks"):
        log(_smi())
        got = spawn_ranks(_class_tp_rank, 2, (root,), device="cuda:0",
                          backend="gloo", timeout=900)
        counters = _kernel_counters()
        for wrapper in counters.values():
            wrapper.launches = 0
        for label, method, batch in _class_tp_cases(root, "cuda:0"):
            logs, u, peak, _, _ = _class_tp_run(method, batch, "cuda:0")
            g = got[label]
            du = float(np.abs(g["u"] - u).max())
            dcrit = float(np.abs(g["crit"] - np.asarray(logs["criterions"])
                                 ).max())
            log(f"class_tp {label}: {len(g['acc'])} tasks, accuracy "
                f"{float(g['acc'].mean()):.6f}, max |du| {du:.3e}, max "
                f"|dcrit| {dcrit:.3e}; collectives a batch {g['calls']} "
                f"moving {g['bytes']} bytes; peak MiB per rank "
                f"{[round(p / 2**20, 1) for p in g['peak']]} against "
                f"{peak / 2**20:.1f} in one process; ms_per_task "
                f"{g['ms']:.4f} on 2 ranks sharing the card (first batch), "
                f"{1e3 * logs['timestamps']:.4f} alone (first batch)")
            if not (np.array_equal(g["preds"], logs["preds"])
                    and np.array_equal(g["acc"], logs["acc"])):
                fail(f"class_tp {label}: predictions or accuracies differ "
                     "from the single-process batch")
            if not (np.allclose(g["u"], u, rtol=0.0, atol=1e-6)
                    and np.allclose(g["crit"], logs["criterions"],
                                    rtol=2e-3, atol=1e-5)):
                fail(f"class_tp {label}: u or the criterions out of limits")
            del u, g["u"]
        launches = got["launches"]
        log(f"class_tp launches summed over the ranks {launches}; the "
            f"same runs in one process "
            f"{ {name: w.launches for name, w in counters.items()} }")
        for name in ("dirichlet_row_solve", "mm_row_solve"):
            if launches[name] <= 0:
                fail(f"the class-TP runs launched {name} 0 times")
        for name, n in launches.items():
            records[name]["class_tp_launches"] = n
        torch.cuda.empty_cache()


def run_synthetic_protocol():
    """Phase synthetic_protocol: scripts/run_synthetic_protocol_torch.py
    --quick --check on the card, in a process of its own; fails unless it
    exits 0."""
    with Phase("synthetic_protocol"):
        out = subprocess.run(
            [sys.executable, os.path.join(
                HERE, "scripts", "run_synthetic_protocol_torch.py"),
             "--quick", "--check"], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        for line in out.stdout.splitlines():
            log(f"synthetic_protocol: {line}")
        if out.returncode != 0:
            fail(f"run_synthetic_protocol_torch.py --quick --check exited "
                 f"{out.returncode}: {out.stderr[-2000:]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    try:
        from transductive_clip_tpu_torch.ops import cuda_attention as ca
        from transductive_clip_tpu_torch.ops import cuda_auction as cau
        from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb
        from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd
        from transductive_clip_tpu_torch.ops import cuda_tim as ct
        from transductive_clip_tpu_torch.ops import dirichlet_fixtures as fx
        from transductive_clip_tpu_torch.ops.auction import (
            auction_assign_reference,
        )
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
        log(_smi())
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
        # no Pallas kernel: the JAX auction is plain XLA (_auction_single
        # under vmap)
        "auction_assign": (cau.auction_assign, auction_assign_reference,
                           "transductive_clip_tpu/ops/auction.py:34",
                           "auction.cu"),
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
            records[name]["ms_rows32"] = time_ms(lambda: wrapper(a0, y),
                                                 inner=10)
            log(f"{name} [{N_TASK}, 32, {N_CLASS}]: ms "
                f"{records[name]['ms_rows32']:.4f}")
        # K2 at the few-shot path's full width, every row live: the kernel
        # alone (its plain version takes seconds a call)
        a0, y = solve_inputs(N_TASK, N_CLASS, N_CLASS, 4, hard_odd=False)
        rec = records["mm_row_solve"]
        rec["ms_full_width"] = time_ms(lambda: cd.mm_row_solve(a0, y), runs=3)
        log(f"mm_row_solve [{N_TASK}, {N_CLASS}, {N_CLASS}] every row live: "
            f"ms {rec['ms_full_width']:.4f}")
        # special.cuh's fast paths against the compiler's operations, on
        # every float of their domains
        bad = fx.check_fast_paths()
        log(f"special.cuh fast paths, floats whose bits differ: {bad}")
        if any(bad.values()):
            fail(f"special.cuh fast paths differ from IEEE fp32: {bad}")
        # untimed edges of the cluster design
        for seed, case in enumerate(fx.SOLVE_EDGES, start=20):
            a0, y = fx.edge_solve_inputs(*case, seed)
            for name in ("dirichlet_row_solve", "mm_row_solve"):
                wrapper, plain, _, _ = kernels[name]
                err = check_kernel(name, wrapper, plain, a0, y,
                                   False)["max_abs_err"]
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], err)
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
                zs + BLOCKING + ["method", "em_dirichlet", "dirichlet_solver",
                                 "pallas"],
                3 * N_TASK, counters)
            launches["dirichlet_row_solve"] = got["dirichlet_row_solve"]
            if got["dirichlet_row_solve"] <= 0:
                fail("the soft main path launched dirichlet_row_solve 0 times")
        with Phase("main_path_hard_mm_pallas"):
            _, _, got, _ = run_main_path(
                root, "hard_em_dirichlet solver=mm_pallas",
                zs + BLOCKING + ["method", "hard_em_dirichlet",
                                 "dirichlet_solver", "mm_pallas"],
                N_TASK, counters)
            launches["mm_row_solve"] = got["mm_row_solve"]
            if got["mm_row_solve"] <= 0:
                fail("the hard main path launched mm_row_solve 0 times")
        with Phase("default_config"):
            run_main_path(root, "em_dirichlet solver=auto",
                          zs + ["method", "em_dirichlet", "dirichlet_solver",
                                "auto"],
                          N_TASK, counters)
        values = run_zero_shot_pipelines(root, counters, records, launches)
        run_auction_checks(records, values)
        del values
        run_few_shot(root, counters, records, launches)
        run_few_shot_pipelines(root, counters)
        run_methods(root, counters, records)
        run_visual_methods(root, counters, records)
        with Phase("profile"):
            for solver in ("pallas", "auto"):
                profile_batch(root, solver)
        run_extraction(root, counters, records, launches)
        run_task_parallel(root, counters, records)
        run_class_tp(root, records)
    run_synthetic_protocol()

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
            # K5's fp32 kernel: a batch of 64 (12 launches), the
            # [64, 14, 14, 1024] / 256 launch alone and a batch of 512
            **({"fp32": {key: rec["fp32"][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                | {"layer3_ms": rec["fp32"]["layer3"]["ms"],
                   "layer3_plain_ms": rec["fp32"]["layer3"]["plain_ms"],
                   "layer3_bound_ms": rec["fp32"]["layer3"]["bound_ms"]}
                | {f"batch_512_{key}": rec["fp32"]["batch_512"][key]
                   for key in ("ms", "plain_ms", "bound_ms")}}
               if "fp32" in rec else {}),
            **{key: rec[key] for key in ("sfu_bound_ms", "ms_full_width",
                                         "few_shot_launches",
                                         "vit_path_launches",
                                         "fp32_path_launches",
                                         "visual_path_launches",
                                         "methods_launches",
                                         "task_parallel_launches",
                                         "class_tp_launches",
                                         "rounds_max",
                                         "rounds_mean", "bids", "scans",
                                         "ms_per_round")
               if key in rec},
        })
    print(json.dumps({"kernels": listing}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
