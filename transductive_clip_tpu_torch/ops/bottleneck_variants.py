"""Times ablations of ``csrc/bottleneck.cu`` beside the source as it
stands, on the card, to show what a part of K5's bf16 kernel costs:

    python -m transductive_clip_tpu_torch.ops.bottleneck_variants
    python -m transductive_clip_tpu_torch.ops.bottleneck_variants --fp32

``--fp32`` builds the source alone and times its fp32 kernel at the four
RN50 identity shapes at batch 64 (median of 5 calls, CUDA events), twice in
turns with the plain version (cuDNN fp32, TF32 off), beside the bound and
the weight bytes the blocks read from L2 (every block reads the three
weight matrices once: batch x strips x their bytes).

A variant is the source with a few textual substitutions, built into
``_build/`` like the kernels themselves. The ablations marked ``wrong``
break the arithmetic: only their times mean anything. All variants are
built together, then timed in turns (source, variants) twice, at the four
RN50 identity shapes at batch 512 in bf16, median of 5 calls (CUDA events).
PERF.md quotes these lines.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from . import cuda_bottleneck as cb
from . import kernel_build
from .common import resolve_device

_MMA = ("mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][2 * (ni & 1)],\n"
        "                     bfr[ni >> 1][2 * (ni & 1) + 1]);")
#: name -> (substitutions, whether the outputs are wrong)
VARIANTS = {
    # no products: the fragment loads stay (their values are still used)
    "no_mma": ([(_MMA, "acc[mi][ni][0] += __uint_as_float("
                       "af[mi][0] ^ bfr[ni >> 1][ni & 1]);")], True),
    # no copies into the ring: the products run on what shared memory holds
    "no_copies": ([("      fill(ahead, (item + kStages - 1) % kStages);\n",
                    "")], True),
    # no stores of a finished tile (h1, h2 and conv3's staging tile)
    "no_tile_store": ([("            if (n < s.n_out)\n",
                        "            if (n < 0)\n")], True),
    # conv3's residual x never read
    "no_x_read": ([("if (off >= 0) xr[i] = *reinterpret_cast<const uint4*>"
                    "(xi + off);",
                    "if (off >= 0) xr[i] = make_uint4(0u, 0u, 0u, 0u);")],
                  True),
    # a ring of two slices instead of three
    "stages2": ([("constexpr int kStages = 3; ", "constexpr int kStages = 2; ")],
                False),
}
#: RN50's identity bottlenecks at batch 512: (H, W, C, Cm)
SHAPES = ((56, 56, 256, 64), (28, 28, 512, 128), (14, 14, 1024, 256),
          (7, 7, 2048, 512))
BATCH = 512
BATCH_F32 = 64
# the card's fp32 FFMA peak (NVIDIA H100 SXM data sheet, 700 W)
PEAK_FP32_S = 67e12


def variant_sources() -> dict:
    """name -> the source text of each variant ('source': unchanged);
    raises if a substitution no longer applies."""
    text = (kernel_build.CSRC / cb.SOURCE).read_text()
    out = {"source": text}
    for name, (subs, _) in VARIANTS.items():
        new = text
        for old, repl in subs:
            if old not in new:
                raise ValueError(f"variant {name}: {old!r} is not in "
                                 f"{cb.SOURCE} any more")
            new = new.replace(old, repl)
        out[name] = new
    return out


def _time_ms(fn, runs=5):
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


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _inputs(g, b, h, w, c, cm, dtype):
    def t(*shape, scale=0.1):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    return (t(b, h, w, c, scale=1.0).to(dtype), t(c, cm).to(dtype),
            t(cm, scale=0.01), t(3, 3, cm, cm).to(dtype), t(cm, scale=0.01),
            t(cm, c).to(dtype), t(c, scale=0.01).to(dtype))


def time_fp32():
    """The fp32 kernel as the source stands, in turns with its plain
    version, at the RN50 identity shapes at batch BATCH_F32."""
    resolve_device("cuda")
    print(_smi())
    kernel_build.build((cb.SOURCE,))
    for line in kernel_build.build_log.get(cb.SOURCE, "").splitlines():
        if "bottleneck_f32" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32
    for turn in range(2):
        for h, w, c, cm in SHAPES:
            args = _inputs(g, BATCH_F32, h, w, c, cm, f32)
            got = cb.fused_identity_bottleneck(*args)
            want = cb.fused_identity_bottleneck_reference(*args)
            rel = ((got - want).abs().max() / want.abs().max()).item()
            kernel = _time_ms(lambda: cb.fused_identity_bottleneck(*args))
            plain = _time_ms(
                lambda: cb.fused_identity_bottleneck_reference(*args))
            rows = cb.strip_rows(h, w, c, cm, f32)
            ops = 2 * BATCH_F32 * h * w * (2 * c * cm + 9 * cm * cm)
            l2 = BATCH_F32 * -(-h // rows) * 4 * (2 * c * cm + 9 * cm * cm)
            print(f"turn {turn} fp32 [{BATCH_F32}, {h}, {w}, {c}] / {cm} "
                  f"R={rows}: kernel {kernel:.4f} ms plain {plain:.4f} ms "
                  f"bound {ops / PEAK_FP32_S * 1e3:.4f} ms "
                  f"({ops / kernel / 1e9:.1f} TFLOP/s) weights from L2 "
                  f"{l2 / 1e9:.3f} GB rel_diff {rel:.3e}", flush=True)
            del args, got, want
            torch.cuda.empty_cache()


def main():
    if "--fp32" in sys.argv[1:]:
        time_fp32()
        return
    resolve_device("cuda")
    print(_smi())
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variant_sources().items():
        path = kernel_build.BUILD_DIR / f"bottleneck_variant_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)     # absolute: kernel_build takes it as is
    kernel_build.build(tuple(paths.values()))
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = [_inputs(g, BATCH, h, w, c, cm, torch.bfloat16)
              for h, w, c, cm in SHAPES]
    try:
        for turn in range(2):
            for name in ["source", *VARIANTS]:
                cb.SOURCE = paths[name]
                cb._library.cache_clear()
                times = [_time_ms(lambda a=a: cb.fused_identity_bottleneck(*a))
                         for a in inputs]
                wrong = name in VARIANTS and VARIANTS[name][1]
                print(f"turn {turn} {name}{' (wrong)' if wrong else ''}: "
                      + "  ".join(f"layer{i + 1} {ms:.4f} ms"
                                  for i, ms in enumerate(times)), flush=True)
    finally:
        cb.SOURCE = "bottleneck.cu"
        cb._library.cache_clear()


if __name__ == "__main__":
    main()
