"""Times variants of ``csrc/attention.cu`` beside the source as it stands,
on the card, to show what a part of K4a / K4b costs:

    python -m transductive_clip_tpu_torch.ops.attention_variants

A variant is the source with a few textual substitutions, built into
``_build/`` like the kernels themselves. The ablations marked ``wrong``
break the arithmetic: only their times mean anything. ``two_pass`` is K4b
bf16 as it was before its wgmma redesign (``csrc/attention_two_pass.cu``,
bf16 K4b only: its K4a and fp32 times are the source's). All variants are
built together, then timed in turns (source, variants, source) twice, at
the shapes ``chip_smoke.py`` times, 10 queued calls a window, median of 5
windows (CUDA events). PERF.md quotes these lines.

:func:`two_pass_blocked` calls the two-pass body with K4b's arguments
(``chip_smoke.py`` times it beside the kernel; it counts no launches).
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from . import cuda_attention as ca
from . import kernel_build
from .common import resolve_device

#: name -> (substitutions, whether the outputs are wrong)
VARIANTS = {
    # q . k^T's d loop of the fp32 kernels unrolled twice (K4b then spills)
    "fp32_unroll2": ([("#pragma unroll 1\n  for (int d = 0; d < kHeadDim",
                       "#pragma unroll 2\n  for (int d = 0; d < kHeadDim")],
                     False),
    # what IEEE expf costs: ex2.approx in its place, and no exp at all
    "fast_exp": ([("expf(", "__expf(")], False),
    "no_exp": ([("expf(", "(")], True),
    # what the Newton step of the division (K4a bf16) costs
    "no_div_step": ([("return fmaf(fmaf(-q, l, e), r, q);", "return q;")],
                    False),
    # K4b bf16: IEEE expf in place of ex2.approx on pre-scaled scores
    "k4b_bf16_expf": ([("asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));",
                        "y = expf(x * 0.69314718055994531f);")], False),
    # K4b bf16: two stages in the ring, not four
    "k4b_bf16_two_stages": ([("constexpr int kStages = 4;",
                              "constexpr int kStages = 2;")], False),
    # K4b bf16: one consumer warpgroup a block (64 q rows), not two
    "k4b_bf16_one_warpgroup": ([("constexpr int kWarpgroups = 2;",
                                 "constexpr int kWarpgroups = 1;")], False),
    # K4b bf16: one resident block an SM (a grid of 132), not two
    "k4b_bf16_one_block": ([("constexpr int kBlocksPerSm = 2;",
                             "constexpr int kBlocksPerSm = 1;")], False),
    # K4b bf16: the max in use moves whenever the running max does
    "k4b_bf16_eager_rescale": ([("constexpr float kSlack = 8.f;",
                                 "constexpr float kSlack = 0.f;")], False),
    # K4b bf16: o / sum value by value, not o times 1 / sum
    "k4b_bf16_divide": ([
        ("pack_bf16(st.o[4 * j] * i0, st.o[4 * j + 1] * i0)",
         "pack_bf16(st.o[4 * j] / st.l0, st.o[4 * j + 1] / st.l0)"),
        ("pack_bf16(st.o[4 * j + 2] * i1, st.o[4 * j + 3] * i1)",
         "pack_bf16(st.o[4 * j + 2] / st.l1, st.o[4 * j + 3] / st.l1)")],
        False),
}
#: the two-pass K4b bf16 of before the wgmma redesign, timed as a variant
TWO_PASS = "attention_two_pass.cu"
#: (wrapper name, b, n, width, heads, dtype, causal)
SHAPES = (
    ("attention_rows", 1000, 77, 512, 8, torch.bfloat16, True),
    ("attention_rows", 1000, 77, 768, 12, torch.float32, True),
    ("attention_blocked", 64, 577, 1024, 16, torch.float32, False),
    ("attention_blocked", 64, 577, 1024, 16, torch.bfloat16, False),
    ("attention_blocked", 256, 197, 768, 12, torch.bfloat16, False),
    ("attention_blocked", 512, 197, 768, 12, torch.bfloat16, False),
)


def variant_sources() -> dict:
    """name -> the source text of each variant ('source': unchanged);
    raises if a substitution no longer applies."""
    text = (kernel_build.CSRC / ca.SOURCE).read_text()
    out = {"source": text}
    for name, (subs, _) in VARIANTS.items():
        new = text
        for old, repl in subs:
            if old not in new:
                raise ValueError(f"variant {name}: {old!r} is not in "
                                 f"{ca.SOURCE} any more")
            new = new.replace(old, repl)
        out[name] = new
    return out


def two_pass_blocked(qkv, heads: int, mask=None):
    """The two-pass K4b bf16 (``TWO_PASS``, built at first use) on a CUDA
    bf16 qkv, as :func:`cuda_attention.attention_blocked` takes it."""
    if qkv.dtype != torch.bfloat16:
        raise ValueError("two_pass_blocked: the two-pass body is bf16 only")
    return ca._launch("tclip_attention_blocked", qkv, heads, mask,
                      lib=ca.bind(kernel_build.load(TWO_PASS)))


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


def main():
    resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variant_sources().items():
        path = kernel_build.BUILD_DIR / f"attention_variant_{name}.cu"
        path.write_text(text)
        paths[name] = str(path)     # absolute: kernel_build takes it as is
    kernel_build.build((*paths.values(), TWO_PASS))
    for name, path in paths.items():
        log = kernel_build.build_log[path].splitlines()
        for i, line in enumerate(log):
            if "Function properties" in line and (
                    "attention_blocked" in line or "attention_rows_f32" in line):
                kernel = line.split("tclip")[1].split("E")[0].lstrip("0123456789")
                print(f"ptxas {name} {kernel}: {log[i + 1].strip()}; "
                      f"{log[i + 2].split(':')[-1].strip()}")
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for wrapper, b, n, width, heads, dtype, causal in SHAPES:
        qkv = torch.randn(b, n, 3 * width, generator=g,
                          device="cuda").to(dtype)
        mask = (torch.full((n, n), float("-inf"), device="cuda").triu(1)
                if causal else None)
        inputs.append((getattr(ca, wrapper), qkv, heads, mask))
    order = ["source", *VARIANTS, "two_pass", "source"]
    try:
        for turn in range(2):
            for name in order:
                if name == "two_pass":
                    times = [_time_ms(lambda a=a: two_pass_blocked(*a[1:]))
                             if a[0] is ca.attention_blocked
                             and a[1].dtype == torch.bfloat16
                             else float("nan") for a in inputs]
                else:
                    ca.SOURCE = paths[name]
                    ca._library.cache_clear()
                    times = [_time_ms(lambda a=args: a[0](*a[1:]))
                             for args in inputs]
                wrong = name in VARIANTS and VARIANTS[name][1]
                print(f"turn {turn} {name}{' (wrong)' if wrong else ''}: "
                      + "  ".join(
                          f"{s[0][10:]} n={s[2]} {str(s[5])[6:]} {t:.4f} ms"
                          for s, t in zip(SHAPES, times)), flush=True)
    finally:
        ca.SOURCE = "attention.cu"
        ca._library.cache_clear()


if __name__ == "__main__":
    main()
