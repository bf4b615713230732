"""The benchmark's entry: one run of one cell (benchmark/run.py)."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

from . import spec

# top-level module names that may not be loaded in the process that
# prints the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "transductive_clip_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root):
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc builds go to its own ``_build/`` there)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv):
    a = parse(argv)
    cache_dirs(spec.ROOT)
    cell = spec.Cell(spec.load_benchmark(), a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, spec.ROOT)
    try:
        importlib.import_module("transductive_clip_tpu_torch")
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    print(f"card: {power_limit()}; torch {torch.__version__}", file=sys.stderr)
    runner = importlib.import_module(f"harness.{cell.config['runner']}")
    record = runner.run(cell, a.seed, a.seconds, bool(a.trace))

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 5
    result = result_line(cell, record, bool(a.trace),
                         torch.cuda.get_device_name(0))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def result_line(cell, record, traced, kind):
    """The run's last line: the keys a checker reads, then the numbers
    compared beside their limits."""
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(record["peak_bytes"])}
    if traced:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
    result = {"correct": bool(record["correct"]),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": spec.read_metrics(cell.metrics(traced), record),
              "device": device}
    if traced:
        from .trace import breakdown

        result["breakdown"] = breakdown(record["trace"])
    result["checks"] = record["checks"]
    return result
