"""Times variants of ``csrc/auction.cu`` beside the source as it stands, on
the card, to show what a part of the auction kernel costs:

    python -m transductive_clip_tpu_torch.ops.auction_variants

A variant is the source with a few textual substitutions, built into
``_build/`` like the kernels themselves, launched through
``cuda_auction.auction_assign``. Every variant keeps the arithmetic, and
its col4row, rounds and scans are checked against the source's. All are
built together, then timed in turns (source, variants, source) twice on
four batches: zero-shot-shaped values (``zero_shot_values``), random
values [100, 75, 1000], the 5 x 5 price wars [125, 5, 5] on a 0.25 grid
and zero-shot-shaped values of 400 tasks (more than the card's SMs); 10
queued calls a window (1 for the price wars), median of 5 windows (CUDA
events). Then the ``clock`` variant prints, for tasks 0 and 1 of the
zero-shot batch and the longest price war, the SM clock cycles (clock64)
of each setup step, of the first round, and of the later rounds' bids (the
scans, and a lone bid's commit) and settling. PERF.md quotes these
lines.
"""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

from . import cuda_auction as ca
from . import kernel_build
from .common import resolve_device

#: name -> substitutions
VARIANTS = {
    # rounds of one bid through the general path (atomicMax, touched list,
    # settle) instead of lane 0 alone
    "one_bid_general": [
        ("      if (n == 1) {\n        if (lane == 0) {",
         "      if (n == -1) {\n        if (lane == 0) {"),
        ("    n = n == 1 ? list_bidders", "    n = n == -1 ? list_bidders")],
    # fewer or more 16-byte loads in flight a lane in the scan of a row
    "scan_loads_2": [("constexpr int kScanLoads = 4;",
                      "constexpr int kScanLoads = 2;")],
    "scan_loads_8": [("constexpr int kScanLoads = 4;",
                      "constexpr int kScanLoads = 8;")],
    # the scan of a row whose C is not a multiple of 4 (the price wars')
    # unrolled eight times
    "scalar_unrolled": [(
        "#pragma unroll 1\n    for (int j = lane; j < n_cols; j += 32)\n"
        "      push(t, __fsub_rn(",
        "#pragma unroll 8\n    for (int j = lane; j < n_cols; j += 32)\n"
        "      push(t, __fsub_rn(")],
}
#: the instrumented copy: clock64 stamps, printed by the tasks named above
CLOCK = [
    ("#include <cstdint>", "#include <cstdint>\n#include <cstdio>"),
    ("  const int tid = threadIdx.x;",
     "  const long long c0 = clock64();\n  const int tid = threadIdx.x;"),
    ("  // 2. each row's leader", "  const long long c1 = clock64();\n"
     "  // 2. each row's leader"),
    ("  // 3. each row's next row", "  const long long c2 = clock64();\n"
     "  // 3. each row's next row"),
    ("  if (warp != 0) return;",
     "  if (warp != 0) return;\n  const long long c3 = clock64();\n"
     "  long long c4 = c3, scan_cycles = 0, settle_cycles = 0;"),
    ("    it = 1;\n", "    it = 1;\n    c4 = clock64();\n"),
    ("    scanned += n;\n    int n_touched = 0;",
     "    scanned += n;\n    const long long r0 = clock64();\n"
     "    int n_touched = 0;"),
    ("    __syncwarp();\n    n = n == 1 ? list_bidders",
     "    __syncwarp();\n    const long long r1 = clock64();\n"
     "    scan_cycles += r1 - r0;\n    n = n == 1 ? list_bidders"),
    ("    ++it;\n  }\n", "    settle_cycles += clock64() - r1;\n"
     "    ++it;\n  }\n"
     "  if (lane == 0 && (blockIdx.x < 2 || it > 1000))\n"
     "    printf(\"clock task %d rounds %d: hash %lld leaders %lld groups "
     "%lld first round %lld later rounds' bids %lld settling %lld total "
     "%lld cycles\\n\", blockIdx.x, it, c1 - c0, c2 - c1, c3 - c2, "
     "c4 - c3, scan_cycles, settle_cycles, clock64() - c0);\n"),
]


def variant_sources() -> dict:
    """name -> the source text of each variant ('source': unchanged, 'clock':
    instrumented); raises if a substitution no longer applies."""
    text = (kernel_build.CSRC / ca.SOURCE).read_text()
    out = {"source": text}
    for name, subs in [*VARIANTS.items(), ("clock", CLOCK)]:
        new = text
        for old, repl in subs:
            if old not in new:
                raise ValueError(f"variant {name}: {old!r} is not in "
                                 f"{ca.SOURCE} any more")
            new = new.replace(old, repl, 1)
        out[name] = new
    return out


def zero_shot_values(n_task=100, n_rows=75, n_cols=1000, seed=0):
    """[n_task, n_rows, n_cols] fp32 shaped as a zero-shot batch's matching
    values: 4 to 10 rows a task (the present clusters, at random places)
    drawn from a Dirichlet(0.05) over the classes, every other row zero."""
    rng = np.random.default_rng(seed)
    values = np.zeros((n_task, n_rows, n_cols), np.float32)
    for t in range(n_task):
        k = int(rng.integers(4, 11))
        rows = rng.choice(n_rows, k, replace=False)
        values[t, rows] = rng.dirichlet(np.full(n_cols, 0.05), k)
    return values


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


def _use(path):
    ca.SOURCE = path
    ca._library.cache_clear()


def main():
    resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variant_sources().items():
        path = kernel_build.BUILD_DIR / f"auction_variant_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)     # absolute: kernel_build takes it as is
    kernel_build.build(tuple(paths.values()))
    for name, path in paths.items():
        for line in kernel_build.build_log[path].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    wars = np.round(np.random.default_rng(0).uniform(
        0, 1, size=(125, 5, 5)).astype(np.float32) * 4) / 4
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = {
        "zero-shot-shaped [100, 75, 1000]": torch.as_tensor(
            zero_shot_values(), device="cuda"),
        "random [100, 75, 1000]": torch.rand(100, 75, 1000, generator=g,
                                             device="cuda"),
        "price wars [125, 5, 5]": torch.as_tensor(wars, device="cuda"),
        # more tasks than SMs: the CTAs a SM holds at once count
        "zero-shot-shaped [400, 75, 1000]": torch.as_tensor(
            zero_shot_values(n_task=400, seed=1), device="cuda"),
    }
    try:
        _use(paths["source"])
        want = {k: ca.auction_assign(v, return_rounds=True, return_scans=True)
                for k, v in batches.items()}
        order = ["source", *VARIANTS, "source"]
        for turn in range(2):
            for name in order:
                _use(paths[name])
                line = []
                for key, v in batches.items():
                    got = ca.auction_assign(v, return_rounds=True,
                                            return_scans=True)
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, want[key])):
                        raise RuntimeError(f"variant {name} differs from the "
                                           f"source on {key}")
                    ms = _time_ms(lambda: ca.auction_assign(v),
                                  calls=1 if v.shape[2] == 5 else 10)
                    line.append(f"{key} {ms:.4f} ms")
                print(f"turn {turn} {name}: " + "  ".join(line), flush=True)
        _use(paths["clock"])
        for key, v in batches.items():
            if "random" not in key and "400" not in key:
                print(f"clock on {key}:", flush=True)
                ca.auction_assign(v)
                torch.cuda.synchronize()
    finally:
        _use("auction.cu")


if __name__ == "__main__":
    main()
