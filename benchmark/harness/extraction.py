"""Extraction cells: whole passes of the port's feature extraction
(``eval.extraction.extract_to_caches``) over a split of uint8 images held
on the card, in batches of the CLI's ``extract_batch_size``, with the
model the CLI's defaults build (``TorchCLIP``: bf16 compute, attention
``auto``).

Set-up makes the weights, the class prompts' token ids and the images on
the card from the seed, builds the model, runs the text tower over the
prompts and warms up every batch shape of a pass. The window runs passes
until ``seconds`` have passed and the pass under way has ended. Each pass
ends with the one fetch of the embeddings and the host softmax against
the text features; the cache writer is replaced by a recorder that keeps
the sampled rows of each pass's softmax features instead of writing a
file. Afterwards the configuration's plain reference
(benchmark/reference/<reference>.py, which also lays out the weights and
counts the work) computes the sampled images' features again in fp32 and
the program's are compared with it."""

from __future__ import annotations

import sys
import time

import numpy as np

from . import clip_inputs, dev, trace


def _say(msg):
    print(msg, file=sys.stderr, flush=True)


def _program_config(cfg):
    """The port's configuration of the cell's towers, built from the
    fields the configuration file states (named as the port's dataclasses
    name them); for a backbone the port names, it has to be the port's own
    entry."""
    from transductive_clip_tpu_torch.models.clip.config import (
        CLIP_CONFIGS,
        CLIPConfig,
        CLIPTextConfig,
        CLIPVisionConfig,
    )

    def fields(d):
        return {k: tuple(x) if isinstance(x, list) else x
                for k, x in d.items()}

    pc = CLIPConfig(name=cfg["backbone"], embed_dim=cfg["embed_dim"],
                    vision=CLIPVisionConfig(**fields(cfg["vision"])),
                    text=CLIPTextConfig(**fields(cfg["text"])))
    known = CLIP_CONFIGS.get(cfg["backbone"])
    if known is not None and known != pc:
        raise ValueError(f"the port's {cfg['backbone']} differs from the "
                         f"cell's configuration: {known} != {pc}")
    return pc


def run(cell, seed, seconds, want_trace, device="cuda:0"):
    t_setup = time.perf_counter()
    import torch

    from transductive_clip_tpu_torch.eval import extraction
    from transductive_clip_tpu_torch.models.clip.model import TorchCLIP

    cfg, tr = cell.config, cell.traffic
    arch = cell.reference()
    pc = _program_config(cfg)
    sd = clip_inputs.state_dict(cfg, arch.layout, seed, device)
    model = TorchCLIP(pc, sd, compute_dtype=None, attention_impl="auto",
                      device=device)
    _say(f"resolved on {dev.name(device)}: compute "
         f"{model.compute_dtype}, attention {model.attention_impl}, "
         f"fused_resnet {model.fused_resnet}")
    tokens = clip_inputs.prompt_tokens(seed, int(cfg["n_class"]),
                                       cfg["text"]["context_length"],
                                       cfg["text"]["vocab_size"], device)
    with torch.no_grad():
        text = model.module.encode_text(tokens).float()
    text_features = text.cpu().numpy()
    text_features /= np.linalg.norm(text_features, axis=-1, keepdims=True)
    n_img, bs = int(tr["images"]), int(tr["batch_size"])
    size = cfg["vision"]["image_size"]
    pixels = clip_inputs.images(seed, n_img, size, device)
    labels = np.arange(n_img) % int(cfg["n_class"])
    batches = [(pixels[i:i + bs], labels[i:i + bs])
               for i in range(0, n_img, bs)]
    for b in sorted({len(x[1]) for x in batches}):
        model.encode_image_batch(pixels[:b])
    dev.sync(device)

    rng = np.random.default_rng(np.random.SeedSequence([seed, 13]))
    sample = np.sort(rng.choice(n_img, size=int(tr["check_images"]),
                                replace=False))
    kept = []

    def recorder(path, feats, feat_labels):
        kept.append(np.array(feats[sample]))

    def one_pass():
        extraction.extract_to_caches(model, batches,
                                     [(float(cfg["T"]), "recorded")],
                                     text_features, write=True)

    saved = extraction.save_feature_cache
    extraction.save_feature_cache = recorder
    try:
        setup_s = time.perf_counter() - t_setup
        dev.reset_peak(device)
        t0 = time.perf_counter()
        passes = 0
        while True:
            one_pass()
            dev.sync(device)
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = dev.peak_bytes(device)
        traced = None
        if want_trace:
            _, traced = trace.traced(one_pass)
    finally:
        extraction.save_feature_cache = saved
    program = np.stack(kept)[:passes]
    record = {
        "setup_s": setup_s, "window_s": window_s, "images": passes * n_img,
        "passes": passes, "peak_bytes": peak, "trace": traced,
        # the traced pass, timed untraced in the window
        "untraced_s": window_s / passes if traced else None,
        **arch.work_counts(cfg, [len(x[1]) for x in batches]),
    }
    _say(f"window: {passes} passes of {n_img} images in {window_s:.4f} s")
    images = pixels[torch.as_tensor(sample, device=pixels.device)]
    del model, batches, pixels
    dev.free(device)
    record.update(check(cfg, arch, sd, tokens, images, program))
    record["attempted"] = passes * n_img
    record["failed"] = 0
    return record


def reference_softmax(cfg, arch, sd, tokens, images, quant=None):
    """The reference's softmax features of ``images`` on the host, fp32
    with TF32 off (``quant``: the control's rounding)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return arch.softmax(cfg, sd, tokens, images, quant).cpu().numpy()


def log_gap(got, ref):
    """The widest gap between the log of a softmax feature and the
    reference's, over every row and class."""
    return float(np.abs(np.log(np.maximum(got, 1e-30))
                        - np.log(np.maximum(ref, 1e-30))).max())


def judge(cfg, passes, ref):
    """(checks, verdict) of every pass's sampled rows against the
    reference's."""
    gap = max(log_gap(p, ref) for p in passes)
    limit = float(cfg["limits"]["log_softmax_gap"])
    return {"log_softmax_gap": {"value": gap, "limit": limit}}, gap <= limit


def check(cfg, arch, sd, tokens, images, program):
    t0 = time.perf_counter()
    ref = reference_softmax(cfg, arch, sd, tokens, images)
    checks, ok = judge(cfg, program, ref)
    _say(f"check: {len(images)} sampled images x {len(program)} passes "
         f"against the reference in {time.perf_counter() - t0:.1f} s")
    return {"correct": ok, "checks": checks}
