#!/usr/bin/env python
"""Validate a user-supplied OpenAI CLIP checkpoint on the PyTorch port
(counterpart of scripts/validate_checkpoint.py).

Runs the port's load -> tower chain on a deterministic probe-image set
and prints pass/fail diagnostics for the first-real-run failure modes
(wrong key layout, transposed kernels, BN mis-fold, bf16 drift, broken text
path), against up to two independent oracles.

    python scripts/validate_checkpoint_torch.py data/clip_weights/RN50.pt
    python scripts/validate_checkpoint_torch.py ViT-B-16.pt --backbone ViT-B/16 \\
        --bpe data/clip_weights/bpe_simple_vocab_16e6.txt.gz --device cpu

It runs on the card (``cuda:0``) unless ``--device`` names another device.
Checks (hard checks gate the exit code; informational rows just print):

1. structure   — the checkpoint's weights match the backbone's state dict
                 (``models.clip.init_random_state_dict``) key for key, in
                 shape                                         [hard]
2. forward     — fp32 probe embeddings are finite, non-degenerate
                 (distinct probes are not collinear)           [hard]
3. fold        — ResNet BN-fold equals the unfolded graph      [hard, RN only]
4. torch-reimpl— cosine vs the repo's independent torch
                 reimplementation (tests/torch_clip.py)        [hard]
5. torchscript — cosine vs the ORIGINAL TorchScript module
                 run in fp32, when the archive is runnable     [hard if loads]
6. bf16        — production-dtype cosine drift vs fp32         [warn < 0.995]
7. text        — tokenized dataset templates encode to finite
                 embeddings; image<->text logit summary        [hard if BPE]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from transductive_clip_tpu_torch.models.clip import (  # noqa: E402
    CLIP_CONFIGS,
    TorchCLIP,
    init_random_state_dict,
)
from transductive_clip_tpu_torch.models.clip.convert import (  # noqa: E402
    load_openai_state_dict,
)
from transductive_clip_tpu_torch.models.clip.preprocess import (  # noqa: E402
    CLIP_MEAN,
    CLIP_STD,
)

# one plausible prompt per dataset template (data/catalog.py)
TEMPLATE_PROMPTS = [
    "a photo of a dog.",
    "a centered satellite photo of forest.",
    "dotted texture.",
    "a photo of a rose, a type of flower.",
    "a photo of pizza, a type of food.",
    "a photo of a person doing archery.",
    "a photo of a boeing, a type of aircraft.",
]


def infer_backbone(sd) -> str:
    """Match the state dict's architecture signature against CLIP_CONFIGS."""
    is_resnet = "visual.layer1.0.conv1.weight" in sd
    embed_dim = int(sd["text_projection"].shape[1])
    if is_resnet:
        width = int(sd["visual.conv1.weight"].shape[0]) * 2
        blocks = []
        for stage in range(1, 5):
            n = 0
            while f"visual.layer{stage}.{n}.conv1.weight" in sd:
                n += 1
            blocks.append(n)
        hw = int(sd["visual.attnpool.positional_embedding"].shape[0]) - 1
        image_size = int(round(hw ** 0.5)) * 32
        sig = (True, width, tuple(blocks), embed_dim, image_size)

        def cfg_sig(cfg):
            v = cfg.vision
            return (v.is_resnet, v.width, tuple(v.resnet_layers),
                    cfg.embed_dim, v.image_size)
    else:
        width = int(sd["visual.conv1.weight"].shape[0])
        patch = int(sd["visual.conv1.weight"].shape[-1])
        grid = int(round((sd["visual.positional_embedding"].shape[0] - 1)
                         ** 0.5))
        image_size = grid * patch
        n_layers = 0
        while (f"visual.transformer.resblocks.{n_layers}.attn.in_proj_weight"
               in sd):
            n_layers += 1
        sig = (False, width, patch, n_layers, embed_dim, image_size)

        def cfg_sig(cfg):
            v = cfg.vision
            return (v.is_resnet, v.width, v.patch_size, v.layers,
                    cfg.embed_dim, v.image_size)

    for name, cfg in CLIP_CONFIGS.items():
        if cfg.vision.is_resnet == is_resnet and cfg_sig(cfg) == sig:
            return name
    raise SystemExit(
        f"checkpoint architecture signature {sig} matches no known backbone "
        f"({sorted(CLIP_CONFIGS)}); pass --backbone explicitly"
    )


def probe_images(image_size: int) -> np.ndarray:
    """Deterministic uint8 probe set: flat fields + seeded noise + gradient."""
    s = image_size
    rng = np.random.default_rng(0)
    grad = np.tile(
        np.linspace(0, 255, s, dtype=np.float32)[None, :, None], (s, 1, 3)
    ).astype(np.uint8)
    return np.stack([
        np.full((s, s, 3), 255, np.uint8),           # white
        np.zeros((s, s, 3), np.uint8),               # black
        np.full((s, s, 3), 128, np.uint8),           # mid gray
        rng.integers(0, 256, (s, s, 3), dtype=np.uint8),  # noise
        grad,                                        # horizontal gradient
    ])


def cosine_rows(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = np.sum(a * b, axis=-1)
    return num / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help="path to an OpenAI CLIP .pt file")
    ap.add_argument("--backbone", default=None,
                    help="override architecture inference (e.g. RN50)")
    ap.add_argument("--bpe", default=None,
                    help="BPE merges file for the text-tower check "
                         "(default: the tokenizer's default path)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: the card (default) or 'cpu'")
    args = ap.parse_args(argv)

    failures = []

    def check(name, ok, detail):
        status = "PASS" if ok else "FAIL"
        print(f"[{status}] {name:<14s} {detail}")
        if not ok:
            failures.append(name)

    sd = load_openai_state_dict(args.checkpoint)
    backbone = args.backbone or infer_backbone(sd)
    cfg = CLIP_CONFIGS[backbone]
    print(f"checkpoint: {args.checkpoint}")
    print(f"backbone:   {backbone} (embed_dim={cfg.embed_dim}, "
          f"image_size={cfg.vision.image_size})")
    n_params = sum(int(np.prod(v.shape)) for v in sd.values())
    scale = float(sd["logit_scale"])
    print(f"state dict: {len(sd)} tensors, {n_params / 1e6:.1f} M params, "
          f"logit_scale=exp({scale:.3f})={float(np.exp(scale)):.2f}")

    # 1. structure: the checkpoint's weights == the backbone's, key for key
    want = {k: tuple(v.shape) for k, v in init_random_state_dict(cfg).items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad_shape = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    check("structure", not (missing or extra or bad_shape),
          f"{len(got)} tensors"
          + (f"; missing={missing[:3]}" if missing else "")
          + (f"; extra={extra[:3]}" if extra else "")
          + (f"; shape mismatch={[(k, got[k], want[k]) for k in bad_shape[:3]]}"
             if bad_shape else ""))
    if missing or extra or bad_shape:
        _finish(failures)

    imgs = probe_images(cfg.vision.image_size)
    imgs_f32 = ((imgs.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD

    def embed(**kw):
        model = TorchCLIP(cfg, sd, device=args.device, **kw)
        return model, model.encode_image_batch(imgs).cpu().numpy()

    # 2. fp32 forward on the probes (+ 3. fold equivalence on ResNets)
    model_f32, emb = embed(compute_dtype=torch.float32)
    norms = np.linalg.norm(emb, axis=-1)
    cos_noise_white = float(cosine_rows(emb[3], emb[0]))
    degenerate = bool(np.allclose(emb[3], emb[0], rtol=1e-3))
    check("forward", np.isfinite(emb).all() and not degenerate,
          f"norms min/mean/max = {norms.min():.2f}/{norms.mean():.2f}/"
          f"{norms.max():.2f}; cos(noise, white) = {cos_noise_white:.4f}")

    if cfg.vision.is_resnet:
        _, emb_u = embed(compute_dtype=torch.float32, fold_bn=False)
        diff = float(np.abs(emb - emb_u).max())
        check("fold", diff < 1e-3 * max(1.0, float(norms.max())),
              f"max |folded - unfolded| = {diff:.2e}")

    # 4. independent torch reimplementation (the test suite's oracle)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_clip

    with torch.no_grad():
        want_emb = torch_clip.encode_image(
            sd, cfg, torch.from_numpy(imgs_f32.transpose(0, 3, 1, 2)),
        ).numpy()
    cos = cosine_rows(emb, want_emb)
    check("torch-reimpl", bool((cos > 0.9999).all()),
          f"min cosine vs tests/torch_clip = {cos.min():.6f}")

    # 5. the original TorchScript module, when the archive is runnable
    try:
        ts = torch.jit.load(args.checkpoint, map_location="cpu").float()
        ts.eval()
        with torch.no_grad():
            want_emb = ts.encode_image(
                torch.from_numpy(imgs_f32.transpose(0, 3, 1, 2))
            ).numpy()
        cos = cosine_rows(emb, want_emb)
        check("torchscript", bool((cos > 0.999).all()),
              f"min cosine vs original TorchScript fp32 = {cos.min():.6f}")
    except Exception as e:  # plain state dicts / non-runnable archives
        print(f"[skip] torchscript   archive not runnable here "
              f"({type(e).__name__})")

    # 6. production-dtype drift
    _, emb_bf = embed(compute_dtype=torch.bfloat16)
    cos = cosine_rows(emb, emb_bf)
    ok = bool((cos > 0.995).all())
    print(f"[{'PASS' if ok else 'WARN'}] bf16           min cosine vs fp32 = "
          f"{cos.min():.6f} (production compute dtype; clip_compute: "
          f"float32 switches back)")

    # 7. text tower through the real tokenizer + the image-text logits
    try:
        from transductive_clip_tpu_torch.models.clip.tokenizer import (
            SimpleTokenizer,
            default_bpe_path,
        )

        tok_path = args.bpe or default_bpe_path()
        if not os.path.exists(tok_path):
            raise FileNotFoundError(tok_path)
        model_f32._tokenizer = SimpleTokenizer(bpe_path=tok_path)
        txt = model_f32.encode_text_prompts(TEMPLATE_PROMPTS).cpu().numpy()
        img_n = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        txt_n = txt / np.linalg.norm(txt, axis=-1, keepdims=True)
        logits = float(np.exp(scale)) * img_n @ txt_n.T
        check("text", bool(np.isfinite(txt).all()),
              f"{len(TEMPLATE_PROMPTS)} templates; image-text logits "
              f"mean={logits.mean():.2f} max={logits.max():.2f}")
    except FileNotFoundError as e:
        print(f"[skip] text          BPE merges file not found ({e}); pass "
              "--bpe <path-to-bpe_simple_vocab_16e6.txt.gz>")

    _finish(failures)


def _finish(failures):
    if failures:
        print(f"\nRESULT: FAIL ({', '.join(failures)})")
        raise SystemExit(1)
    print("\nRESULT: OK — checkpoint is safe to use for extraction")
    raise SystemExit(0)


if __name__ == "__main__":
    main()
