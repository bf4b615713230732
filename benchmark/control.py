#!/usr/bin/env python3
"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place, computed in the nearest precision
below the configuration's, and judged by the cell's own check. A control
has to come out as not correct; its readings set the upper end of each
limit (PERF.md). The benchmark's own runs never run it.

    python3 benchmark/control.py --workload em_dirichlet_imagenet.zs \
        --seeds 11 12 13

Task cells: the reference with every product's operands rounded to TF32
(the configuration states fp32 with TF32 off), on tasks drawn as a run
draws them. Extraction cells: the reference with
every product fed in fp8 e4m3 (the configuration states bf16) on the
images a run checks. One JSON line per seed: the checks' values beside
their limits.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import spec  # noqa: E402


def task_control(cell, seed, device):
    """The reference against itself at the control's precision
    (``CONTROL`` of the configuration's reference module), on tasks drawn
    by the plain protocol sampler (reference/sampler.py) from the same
    seeds, as many as a run checks."""
    import numpy as np

    from harness import task_eval
    from reference import sampler

    cfg, tr = cell.config, cell.traffic
    n_class = int(cfg["n_class"])
    few = int(tr["shots"]) > 0
    test, train = task_eval.tables(cfg, few, device)
    bs = int(tr["batch_size"])
    tasks_per_eval = int(tr["number_tasks"]) // bs * bs
    picks = task_eval.sample_tasks(seed, int(tr["evaluations"]),
                                   tasks_per_eval, int(tr["check_tasks"]))
    jobs = []
    for e in sorted({e for e, _ in picks}):
        rows = [t for ee, t in picks if ee == e]
        s_eed = task_eval.eval_seed(int(cfg["data_seed"]), e)
        if few:
            idx_s, idx_q = sampler.few_shot_tasks(
                s_eed, train[1], test[1], n_class, int(tr["shots"]),
                int(tr["n_query"]), int(tr["k_eff"]), tasks_per_eval, bs)
            jobs += [(idx_s[t], idx_q[t]) for t in rows]
        else:
            idx_q = sampler.zero_shot_tasks(s_eed, test[1], n_class,
                                            int(tr["n_query"]),
                                            tasks_per_eval, bs)
            jobs += [(None, idx_q[t]) for t in rows]
    labels = np.stack([test[1][q] for _, q in jobs])
    ref, _ = task_eval.reference_answers(cell, jobs, test, train,
                                         device=device)
    ctl, _ = task_eval.reference_answers(cell, jobs, test, train,
                                         quant=cell.reference().CONTROL,
                                         device=device)
    acc = (ctl == labels).mean(1).astype(np.float32)
    if few:
        ctl = n_class - 1 - ctl
    return task_eval.compare(cfg, tr, ctl, acc, ref, labels)


def extraction_control(cell, seed, device):
    import numpy as np
    import torch

    from harness import clip_inputs, extraction

    cfg, tr = cell.config, cell.traffic
    arch = cell.reference()
    sd = clip_inputs.state_dict(cfg, arch.layout, seed, device)
    tokens = clip_inputs.prompt_tokens(seed, int(cfg["n_class"]),
                                       cfg["text"]["context_length"],
                                       cfg["text"]["vocab_size"], device)
    n_img = int(tr["images"])
    pixels = clip_inputs.images(seed, n_img, cfg["vision"]["image_size"],
                                device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 13]))
    sample = np.sort(rng.choice(n_img, size=int(tr["check_images"]),
                                replace=False))
    images = pixels[torch.as_tensor(sample, device=device)]
    del pixels
    ref = extraction.reference_softmax(cfg, arch, sd, tokens, images)
    ctl = extraction.reference_softmax(cfg, arch, sd, tokens, images,
                                       quant=arch.CONTROL)
    return extraction.judge(cfg, [ctl], ref)


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(), a.workload)
    sys.path.insert(0, spec.ROOT)
    for seed in a.seeds:
        if cell.config["runner"] == "task_eval":
            checks, ok = task_control(cell, seed, a.device)
        else:
            checks, ok = extraction_control(cell, seed, a.device)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_correct": ok, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
