"""Times the Dirichlet row-solve kernels K1 and K2 (``csrc/dirichlet_solve.cu``)
beside textual variants of them, on the card:

    python -m transductive_clip_tpu_torch.ops.dirichlet_variants \
        [--full-width] [--scaling] [--only NAME ...]
    python -m transductive_clip_tpu_torch.ops.dirichlet_variants --newton-reads

Two bases. ``source`` is ``csrc/dirichlet_solve.cu`` as it stands.
``first`` is the kernels' first design (one thread block of up to 1024
threads per stopping block, rows dealt to warps by index, the state in the
output buffer in device memory), kept here as text with the ``special.cuh``
of its time inlined: this module is the only place it lives on. A variant
is a base with a few textual substitutions, or the source under other
launch-geometry constants. Those marked ``wrong`` break the arithmetic: only
their times mean anything. Every variant is built into ``_build/`` with the
kernels' own flags, all ``nvcc`` processes started together, then timed in
turns (every variant, then every variant again) at [100, 91, 1000] and
[100, 32, 1000] on the inputs ``chip_smoke.py`` times (median of 5 windows
of 10 calls, CUDA events), in two modes:

* ``called``: the wrappers' defaults, each block stopping by its criterion;
* ``fixed``: tol 0, so every block runs exactly 24 Minka iterations (K1)
  or 100 MM updates (K2), whatever a variant does to the values.

Before the timings, the source's cluster occupancy (how many clusters the
card holds at once) at a few geometries. ``--full-width`` also times K2 of
``first`` and ``source`` at [100, 1000, 1000] with every row live (the
few-shot path's full-width launches), as called, in turns (first, source,
source, first); ``--scaling`` the source variants at [n, 91, 1000] with
every task dense, fixed work, for n in SCALING. Each variant's library
prints its static SASS counts per kernel (instructions, MUFU operations by
kind, division slow-path calls) from ``cuobjdump -sass``.

``--newton-reads`` builds nothing and times the zero-shot soft ``auto``
evaluation instead (``newton_reads``), with the Newton-Minka solve's stop
flag read every 1, 2 or 4 steps (``dirichlet.NEWTON_CHECK_EVERY``).
PERF.md quotes these lines.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess

import torch

from . import cuda_dirichlet as cd
from . import dirichlet_fixtures as fx
from . import kernel_build
from .common import resolve_device

_FRCP = "__frcp_rn"
#: name -> (base, substitutions, whether the outputs are wrong[, the
#: wrappers' geometry constants to set])
VARIANTS = {
    "source": ("source", [], False),
    # the launch geometry's warps an SM
    "source_warps16": ("source", [], False, {"TARGET_WARPS_SM": 16}),
    "source_warps40": ("source", [], False, {"TARGET_WARPS_SM": 40}),
    # 1024 threads a CTA: one CTA an SM by registers at every width
    "source_warps64": ("source", [], False, {"TARGET_WARPS_SM": 64}),
    # the cluster scheduler asked to spread a cluster's CTAs over SMs
    "source_spread": ("source", [
        ("  cfg.numAttrs = 1;",
         "  static cudaLaunchAttribute both[2];\n  both[0] = attr;\n"
         "  both[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;\n"
         "  both[1].val.clusterSchedulingPolicyPreference =\n"
         "      cudaClusterSchedulingPolicySpread;\n"
         "  cfg.attrs = both;\n  cfg.numAttrs = 2;")],
        False),
    "first": ("first", [], False),
    # (b) no write-back: the state never changes, its loads stay
    "first_no_writeback": ("first", [("a_row[j] = a_new;",
                                  "if (a_new == -1.0f) a_row[j] = a_new;")],
                         True),
    # (c) every IEEE division a multiplication by __frcp_rn or by a
    # constant reciprocal
    "first_div_as_rcp": ("first", [
        ("inv2 / 252.0f", "inv2 * (1.0f / 252.0f)"),
        ("inv2 / 1260.0f", "inv2 * (1.0f / 1260.0f)"),
        ("inv2 / 42.0f", "inv2 * (1.0f / 42.0f)"),
        ("(dg - y) / tg", f"(dg - y) * {_FRCP}(tg)"),
        ("-1.0f / (y + kEulerGamma)", f"-{_FRCP}(y + kEulerGamma)"),
        ("1.0f / x", f"{_FRCP}(x)"),
        ("/ (a * a)", f"* {_FRCP}(a * a)"),
        ("/ (2.0f * curv)", f"* {_FRCP}(2.0f * curv)"),
    ], True),
    # what IEEE rounding of all of them costs: the bare MUFU.RCP instead
    "first_rcp_approx": ("first", [
        ("inv2 / 252.0f", "inv2 * (1.0f / 252.0f)"),
        ("inv2 / 1260.0f", "inv2 * (1.0f / 1260.0f)"),
        ("inv2 / 42.0f", "inv2 * (1.0f / 42.0f)"),
        ("(dg - y) / tg", "__fdividef(dg - y, tg)"),
        ("-1.0f / (y + kEulerGamma)", "-__fdividef(1.0f, y + kEulerGamma)"),
        ("1.0f / x", "__fdividef(1.0f, x)"),
        ("/ (a * a)", "* __fdividef(1.0f, a * a)"),
        ("/ (2.0f * curv)", "* __fdividef(1.0f, 2.0f * curv)"),
    ], True),
    # what the libm-accurate logf costs: MUFU.LG2 instead
    "first_fast_log": ("first", [("logf(", "__logf(")], True),
    # (d) a stopping block's rows over 8 thread blocks, each stopping alone
    "first_split8": ("first", [
        ("  dim3 grid, threads;\n",
         "  dim3 grid, threads;\n  block_rows = (block_rows + 7) / 8;\n")],
        True),
}
_GEOMETRY = {"TARGET_WARPS_SM": cd.TARGET_WARPS_SM}
SHAPES = ((100, 91, 1000), (100, 32, 1000))
#: --scaling: dense [n, 91, 1000] tasks, n clusters of 8 CTAs
SCALING = (1, 2, 4, 8, 16, 17, 33, 34, 50, 66, 100)
FULL_WIDTH = (100, 1000, 1000)
#: fixed-work mode: K1 iterations, K2 updates
FIXED_ITERS, FIXED_UPDATES = 24, 100

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the first design's launchers: (alpha0, y, out, n_task, n_rows, k, block_rows,
# max_iters | iter_mm, tol, newton_iters | check_every, stream)
_FIRST_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]

FIRST_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>

namespace tclip {

constexpr float kEulerGamma = (float)0.5772156649015329;
constexpr float kHalfLog2Pi = (float)0.9189385332046727;
constexpr float kInv12 = (float)(1.0 / 12.0);
constexpr float kInv120 = (float)(1.0 / 120.0);
constexpr float kInv360 = (float)(1.0 / 360.0);
constexpr float kInv6 = (float)(1.0 / 6.0);
constexpr float kInv30 = (float)(1.0 / 30.0);

__device__ __forceinline__ float digamma_pos(float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = acc - 1.0f / x;
    x = x + 1.0f;
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  const float series =
      logf(x) - 0.5f * inv - inv2 * (kInv12 - inv2 * (kInv120 - inv2 / 252.0f));
  return series + acc;
}

__device__ __forceinline__ float lgamma_pos(float x) {
  float shift = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    shift = shift + logf(x);
    x = x + 1.0f;
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  const float series = (x - 0.5f) * logf(x) - x + kHalfLog2Pi +
                       inv * (kInv12 - inv2 * (kInv360 - inv2 / 1260.0f));
  return series - shift;
}

__device__ __forceinline__ void digamma_and_trigamma_pos(float x, float& dg,
                                                         float& tg) {
  float acc0 = 0.0f;
  float acc1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = 1.0f / x;
    acc0 = acc0 - r;
    acc1 = acc1 + r * r;
    x = x + 1.0f;
  }
  const float inv = 1.0f / x;
  const float inv2 = inv * inv;
  const float logx = logf(x);
  dg = logx - 0.5f * inv - inv2 * (kInv12 - inv2 * (kInv120 - inv2 / 252.0f)) +
       acc0;
  tg = inv + 0.5f * inv2 + inv * inv2 * (kInv6 - inv2 * (kInv30 - inv2 / 42.0f)) +
       acc1;
}

__device__ __forceinline__ float inv_digamma(float y, int newton_iters) {
  float x = (y >= -2.22f) ? expf(y) + 0.5f : -1.0f / (y + kEulerGamma);
  for (int i = 0; i < newton_iters; ++i) {
    float dg, tg;
    digamma_and_trigamma_pos(x, dg, tg);
    x = x - (dg - y) / tg;
    x = (x < 1e-10f) ? 1e-10f : x;  // a NaN passes through, as in torch/jnp

  }
  return x;
}

}  // namespace tclip

namespace tclip {

constexpr float kRowFreeze = 1.0f;
constexpr float kTrigamma1 = (float)(3.141592653589793 * 3.141592653589793 / 6.0);
constexpr float kAlphaFloor = 1e-11f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < n_warps ? scratch[lane] : make_float2(0.0f, 0.0f);
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  const float2 total = scratch[32];
  __syncthreads();  // scratch is reused by the next call
  return total;
}

__device__ __forceinline__ bool row_live(const float* y_row) {
  return y_row[0] < kRowFreeze / 2;
}

struct Block {
  const float* y;
  float* state;
  int rows;
};

__device__ __forceinline__ Block block_setup(const float* __restrict__ alpha0,
                                             const float* __restrict__ y,
                                             float* __restrict__ out,
                                             int n_rows, int k, int block_rows) {
  const int row0 = blockIdx.x * block_rows;
  const size_t base = ((size_t)blockIdx.y * n_rows + row0) * (size_t)k;
  Block b;
  b.y = y + base;
  b.state = out + base;
  b.rows = min(block_rows, n_rows - row0);
  const int n = b.rows * k;
  for (int i = threadIdx.x; i < n; i += blockDim.x) b.state[i] = alpha0[base + i];
  __syncthreads();
  return b;
}

__device__ __forceinline__ void minka_pass(const Block& b, int k, int newton_iters,
                                           float& num, float& den) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < b.rows; r += n_warps) {
    const float* y_row = b.y + (size_t)r * k;
    if (!row_live(y_row)) continue;  // warp-uniform
    float* a_row = b.state + (size_t)r * k;
    float s = 0.0f;
    for (int j = lane; j < k; j += 32) s += a_row[j];
    const float psi_s = digamma_pos(warp_sum(s));
    for (int j = lane; j < k; j += 32) {
      const float a = a_row[j];
      const float a_new = inv_digamma(psi_s + __ldg(y_row + j), newton_iters);
      const float d = a_new - a;
      num += d * d;
      den += a * a;
      a_row[j] = a_new;
    }
  }
}

__global__ void dirichlet_row_solve_kernel(const float* __restrict__ alpha0,
                                           const float* __restrict__ y,
                                           float* __restrict__ out, int n_rows,
                                           int k, int block_rows, int max_iters,
                                           float tol, int newton_iters) {
  __shared__ float2 scratch[33];
  const Block b = block_setup(alpha0, y, out, n_rows, k, block_rows);
  float crit = INFINITY;
  for (int it = 0; it < max_iters && crit >= tol; ++it) {
    float num = 0.0f, den = 0.0f;
    minka_pass(b, k, newton_iters, num, den);
    const float2 t = block_sum2(num, den, scratch);
    crit = t.x / fmaxf(t.y, kDenFloor);
  }
}

__device__ __forceinline__ float mm_update(float a, float psi_s, float y) {
  const float digam = digamma_pos(a + 1.0f);
  const float curv =
      a > kAlphaFloor
          ? fabsf(2.0f * (digam * a - lgamma_pos(a + 1.0f)) / (a * a))
          : kTrigamma1;
  const float b = digam - psi_s - curv * a - y;
  return (-b + sqrtf(b * b + 4.0f * curv)) / (2.0f * curv);
}

template <bool kMeasure>
__device__ __forceinline__ void mm_pass(const Block& b, int k, float& num,
                                        float& den) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < b.rows; r += n_warps) {
    const float* y_row = b.y + (size_t)r * k;
    if (!row_live(y_row)) continue;  // warp-uniform
    float* a_row = b.state + (size_t)r * k;
    float s = 0.0f;
    for (int j = lane; j < k; j += 32) s += a_row[j];
    const float psi_s = digamma_pos(warp_sum(s));
    for (int j = lane; j < k; j += 32) {
      const float a = a_row[j];
      const float a_new = mm_update(a, psi_s, __ldg(y_row + j));
      if (kMeasure) {
        const float d = a_new - a;
        num += d * d;
        den += a * a;
      }
      a_row[j] = a_new;
    }
  }
}

__global__ void mm_row_solve_kernel(const float* __restrict__ alpha0,
                                    const float* __restrict__ y,
                                    float* __restrict__ out, int n_rows, int k,
                                    int block_rows, int iter_mm, float tol,
                                    int check_every) {
  __shared__ float2 scratch[33];
  const Block b = block_setup(alpha0, y, out, n_rows, k, block_rows);
  float unused = 0.0f;
  const int first = min(check_every, iter_mm);
  for (int i = 0; i < first; ++i) mm_pass<false>(b, k, unused, unused);
  float crit = INFINITY;
  for (int it = first; it < iter_mm && crit >= tol;) {
    float num = 0.0f, den = 0.0f;
    mm_pass<true>(b, k, num, den);
    const float2 t = block_sum2(num, den, scratch);
    crit = t.x / fmaxf(t.y, kDenFloor);
    const int rem = min(check_every - 1, iter_mm - it - 1);
    if (!(crit < tol))
      for (int i = 0; i < rem; ++i) mm_pass<false>(b, k, unused, unused);
    it += 1 + rem;
  }
}

inline int launch_shape(int n_task, int n_rows, int k, int block_rows,
                        dim3& grid, dim3& threads) {
  if (n_task <= 0 || n_task > 65535 || n_rows <= 0 || k <= 0 || block_rows <= 0)
    return (int)cudaErrorInvalidValue;
  grid = dim3((n_rows + block_rows - 1) / block_rows, n_task);
  threads = dim3(32 * (block_rows < 32 ? block_rows : 32));
  return 0;
}

}  // namespace tclip

extern "C" const char* tclip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int tclip_dirichlet_row_solve(const float* alpha0, const float* y,
                                         float* out, int n_task, int n_rows,
                                         int k, int block_rows, int max_iters,
                                         float tol, int newton_iters,
                                         void* stream) {
  dim3 grid, threads;
  const int rc = tclip::launch_shape(n_task, n_rows, k, block_rows, grid, threads);
  if (rc != 0) return rc;
  tclip::dirichlet_row_solve_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha0, y, out, n_rows, k, block_rows, max_iters, tol, newton_iters);
  return (int)cudaGetLastError();
}

extern "C" int tclip_mm_row_solve(const float* alpha0, const float* y, float* out,
                                  int n_task, int n_rows, int k, int block_rows,
                                  int iter_mm, float tol, int check_every,
                                  void* stream) {
  dim3 grid, threads;
  const int rc = tclip::launch_shape(n_task, n_rows, k, block_rows, grid, threads);
  if (rc != 0) return rc;
  tclip::mm_row_solve_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha0, y, out, n_rows, k, block_rows, iter_mm, tol, check_every);
  return (int)cudaGetLastError();
}
"""


def variant_sources() -> dict:
    """name -> the source text of each variant; raises if a substitution no
    longer applies."""
    bases = {"first": FIRST_SOURCE,
             "source": (kernel_build.CSRC / cd.SOURCE).read_text()}
    out = {}
    for name, (base, subs, *_) in VARIANTS.items():
        text = bases[base]
        for old, repl in subs:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} is not in its "
                                 f"base {base} any more")
            text = text.replace(old, repl)
        out[name] = text
    return out


def _time_ms(fn, calls=10, windows=5):
    fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def _first_callers(path):
    """K1 and K2 of a library of the first design, called as its wrappers
    called them: (alpha0, y, iteration budget, tol) -> alpha."""
    lib = kernel_build.load(path)
    for fn in ("tclip_dirichlet_row_solve", "tclip_mm_row_solve"):
        getattr(lib, fn).argtypes = _FIRST_ARGTYPES
        getattr(lib, fn).restype = _I

    def launcher(fn, last):
        def call(a0, y, budget, tol):
            out = torch.empty_like(a0)
            n, r, k = a0.shape
            rc = getattr(lib, fn)(
                a0.data_ptr(), y.data_ptr(), out.data_ptr(), n, r, k,
                cd.block_rows_for(r), budget, tol, last,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{fn}: launch failed (cuda error {rc})")
            return out
        return call

    return (launcher("tclip_dirichlet_row_solve", 3),
            launcher("tclip_mm_row_solve", 50))


def _source_callers(path):
    """K1 and K2 through the wrappers, on the library built from ``path``."""
    cd.SOURCE = path
    cd._library.cache_clear()
    return (lambda a0, y, budget, tol: cd.dirichlet_row_solve(
                a0, y, max_iters=budget, tol=tol),
            lambda a0, y, budget, tol: cd.mm_row_solve(
                a0, y, iter_mm=budget, tol=tol))


def _callers(name, path):
    base, _, _, *geometry = VARIANTS[name]
    for key, value in dict(_GEOMETRY, **(geometry[0] if geometry else {})).items():
        setattr(cd, key, value)
    return (_first_callers if base == "first" else _source_callers)(path)


def sass_counts(lib_path) -> dict:
    """kernel -> static SASS counts of the library's kernels: instructions,
    MUFU operations by kind, and CALL (the division slow paths)."""
    tool = os.path.join(os.path.dirname(kernel_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or tool
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = ("K1" if "dirichlet_row_solve" in name else
                    "K2" if "mm_row_solve" in name else name)
            counts[name] = {"instructions": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if name is None or m is None:
            continue
        op = m.group(2)
        if op == "NOP":
            continue
        c = counts[name]
        c["instructions"] += 1
        if op.startswith("MUFU") or op.startswith("CALL") or op == "FCHK":
            c[op] = c.get(op, 0) + 1
    return counts


#: NEWTON_CHECK_EVERY of each turn of ``newton_reads``: each value as often
#: as the others, in each position of the order as often
NEWTON_TURNS = (1, 2, 4, 4, 2, 1, 1, 2, 4, 4, 2, 1)
#: steady batches after the first: a 1000-task evaluation in batches of 100
NEWTON_STEADY = 9


def newton_reads():
    """The zero-shot soft EM-Dirichlet evaluation with ``dirichlet_solver
    auto`` (the Newton-Minka solve) at the ImageNet protocol (batches of
    100 tasks x 75 queries x K = 1000, synthetic softmax features), timed
    on the host clock with ``NEWTON_CHECK_EVERY`` set to each k in
    NEWTON_TURNS. A turn is a fresh method over the same 1 + NEWTON_STEADY
    batches: the first hosts the compact_first guard's full-width solves,
    the others are steady. Prints each turn's wall clock, host syncs and
    Newton steps for the first batch and the steady ones, then the median
    of each k; raises if a turn's predictions differ from the warm-up's."""
    import time
    from pathlib import Path

    import numpy as np

    from ..core.config import load_full_config
    from ..core.profiling import PhaseTimer
    from ..methods import get_zero_shot_method
    from ..utils.synthetic import make_zero_shot_tasks
    from . import dirichlet as td
    from .common import to_host

    cfg = load_full_config(
        opts=["dataset", "imagenet", "method", "em_dirichlet", "shots", "0",
              "n_query", "75", "dirichlet_solver", "auto"],
        config_root=str(Path(__file__).resolve().parents[2] / "config"))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(1 + NEWTON_STEADY):
        x, y = make_zero_shot_tasks(rng, 100, 75, 1000)
        batches.append({"x_q": torch.as_tensor(x, device="cuda"),
                        "y_q": y[..., None]})
    def evaluation():
        method = get_zero_shot_method(cfg.name_method, args=cfg)
        out = []
        for task in batches:
            torch.cuda.synchronize()
            to_host.syncs = 0
            t0 = time.perf_counter()
            with PhaseTimer().active() as timer:
                logs = method.run_task(task)
            out.append(((time.perf_counter() - t0) * 1e3, to_host.syncs,
                        int(timer.totals["newton.steps"]), logs["preds"]))
        return out

    default = td.NEWTON_CHECK_EVERY
    totals = {}
    try:
        preds = [p for *_, p in evaluation()]        # warm-up
        for k in NEWTON_TURNS:
            td.NEWTON_CHECK_EVERY = k
            runs = evaluation()
            if any(not np.array_equal(p, q) for (*_, p), q in zip(runs, preds)):
                raise RuntimeError(f"NEWTON_CHECK_EVERY = {k} changed the "
                                   "predictions")
            first, rest = runs[0], runs[1:]
            total = first[0] + sum(r[0] for r in rest)
            totals.setdefault(k, []).append((total, first[0]))
            print(f"newton reads every {k}: first_ms {first[0]:.3f} "
                  f"syncs {first[1]} steps {first[2]}  steady_ms "
                  f"{sum(r[0] for r in rest):.3f} syncs "
                  f"{sum(r[1] for r in rest)} steps {sum(r[2] for r in rest)}"
                  f"  total_ms {total:.3f}", flush=True)
    finally:
        td.NEWTON_CHECK_EVERY = default
    for k, got in sorted(totals.items()):
        print(f"newton reads every {k}: median total_ms "
              f"{statistics.median(t for t, _ in got):.3f} first_ms "
              f"{statistics.median(f for _, f in got):.3f} over {len(got)} "
              "turns", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--full-width", action="store_true",
                        help="also time K2 at [100, 1000, 1000]")
    parser.add_argument("--scaling", action="store_true",
                        help="also time the source at [n, 91, 1000], every "
                        "task dense, fixed work, for n in SCALING")
    parser.add_argument("--only", nargs="*", default=None,
                        help="time only these variants")
    parser.add_argument("--newton-reads", action="store_true",
                        help="time the zero-shot auto evaluation by the "
                        "Newton-Minka flag's read interval, and nothing else")
    args = parser.parse_args(argv)
    resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.newton_reads:
        newton_reads()
        return
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variant_sources().items():
        if args.only is not None and name not in args.only:
            continue
        path = kernel_build.BUILD_DIR / f"dirichlet_variant_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)     # absolute: kernel_build takes it as is
    kernel_build.build(tuple(paths.values()))
    for name, path in paths.items():
        for line in kernel_build.build_log[path].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        for kernel, c in sass_counts(kernel_build.library_path(path)).items():
            print(f"sass {name} {kernel}: " + " ".join(
                f"{k} {v}" for k, v in sorted(c.items())), flush=True)
    if "source" in paths:
        _callers("source", paths["source"])
        lib = cd._library()
        lib.tclip_dirichlet_max_clusters.argtypes = [_I, _I, _I, _I, _P]
        lib.tclip_dirichlet_max_clusters.restype = _I
        for r, k in ((91, 1000), (32, 1000), (1000, 1000)):
            g = cd.launch_geometry(r, k)
            for ctas in (2, 4, 8):
                for threads in sorted({g["threads"], 256, 512, 1024}):
                    rows = -(-g["block_rows"] // ctas)
                    smem = 8 * rows * k
                    if smem + cd.SMEM_STATIC > cd.SMEM_MAX:
                        continue
                    got = ctypes.c_int(0)
                    rc = lib.tclip_dirichlet_max_clusters(
                        0, ctas, threads, smem, ctypes.byref(got))
                    print(f"occupancy R={r} K={k} ctas {ctas} threads "
                          f"{threads} smem {smem}: max active clusters "
                          f"{got.value} ({got.value * ctas} CTAs; rc {rc})",
                          flush=True)
    inputs = [(shape, fx.synthetic_solve_inputs(*shape, seed=seed))
              for seed, shape in enumerate(SHAPES, start=1)]
    modes = {"called": ((60, 1e-11), (1000, 1e-11)),
             "fixed": ((FIXED_ITERS, 0.0), (FIXED_UPDATES, 0.0))}
    try:
        for turn in range(2):
            for name in paths:
                k1, k2 = _callers(name, paths[name])
                parts = []
                for shape, (a0, y) in inputs:
                    for mode, budgets in modes.items():
                        for kname, fn, (budget, tol) in (("K1", k1, budgets[0]),
                                                         ("K2", k2, budgets[1])):
                            t = _time_ms(lambda: fn(a0, y, budget, tol))
                            parts.append(f"{kname} R={shape[1]} {mode} {t:.4f}")
                wrong = " (wrong)" if VARIANTS[name][2] else ""
                wrong += "".join(f" {k}={v}" for k, v in (
                    VARIANTS[name][3] if len(VARIANTS[name]) > 3 else {}).items())
                print(f"turn {turn} {name}{wrong} ms: " + "  ".join(parts),
                      flush=True)
        if args.scaling:
            a0, y = fx.synthetic_solve_inputs(max(SCALING), 91, 1000, seed=5,
                                              hard_odd=False)
            for name in [n for n in paths if VARIANTS[n][0] == "source"]:
                k1, k2 = _callers(name, paths[name])
                for n in SCALING:
                    a, b = a0[:n].contiguous(), y[:n].contiguous()
                    t1 = _time_ms(lambda: k1(a, b, FIXED_ITERS, 0.0))
                    t2 = _time_ms(lambda: k2(a, b, FIXED_UPDATES, 0.0))
                    print(f"scaling {name} [{n}, 91, 1000] dense fixed ms: "
                          f"K1 {t1:.4f} K2 {t2:.4f}", flush=True)
            del a0, y, a, b
        if args.full_width:
            del inputs
            a0, y = fx.synthetic_solve_inputs(*FULL_WIDTH, seed=4,
                                              hard_odd=False)
            for name in [n for n in ("first", "source", "source", "first")
                         if n in paths]:
                _, k2 = _callers(name, paths[name])
                t = _time_ms(lambda: k2(a0, y, 1000, 1e-11), calls=1,
                             windows=3)
                print(f"full width {name} K2 {list(FULL_WIDTH)} called ms "
                      f"{t:.4f}", flush=True)
    finally:
        cd.SOURCE = "dirichlet_solve.cu"
        cd._library.cache_clear()


if __name__ == "__main__":
    main()
