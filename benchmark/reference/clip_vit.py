"""Plain CLIP ViT image and text towers in fp32: the reference that the
extraction cell holds the program's softmax features against.

Written from OpenAI's CLIP (Radford et al. 2021; clip/model.py:
VisionTransformer, Transformer, ResidualAttentionBlock with QuickGELU,
the text tower pooled at the end-of-text token) over a state dict with
OpenAI's keys, in plain torch: no kernel, no fused attention, fp32 with
TF32 off. ``quant`` (None for the reference) is applied to both operands of
every product, which makes the lower-precision control. Imports nothing of
the program.

What the extraction cells need of an architecture sits here, found by the
reference's name in the configuration file: ``layout`` (the weights),
``softmax`` (the reference's features), ``work_counts`` (the frozen counts of
harness/work.py at the cell's shapes) and ``CONTROL``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from harness import work

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


def _q(quant, *xs):
    return xs if quant is None else tuple(quant(x) for x in xs)


def linear(x, w, b, quant=None):
    x, w = _q(quant, x, w)
    return x @ w.t() + b


def block(x, sd, p, heads, mask=None, quant=None):
    b, n, width = x.shape
    d = width // heads
    h = F.layer_norm(x, (width,), sd[f"{p}.ln_1.weight"],
                     sd[f"{p}.ln_1.bias"], LN_EPS)
    qkv = linear(h, sd[f"{p}.attn.in_proj_weight"],
                 sd[f"{p}.attn.in_proj_bias"], quant)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2)
               for t in qkv.split(width, dim=-1))
    q, k = _q(quant, q * d ** -0.5, k)
    s = q @ k.transpose(-1, -2)
    if mask is not None:
        s = s + mask
    a, v = _q(quant, torch.softmax(s, dim=-1), v)
    o = (a @ v).transpose(1, 2).reshape(b, n, width)
    x = x + linear(o, sd[f"{p}.attn.out_proj.weight"],
                   sd[f"{p}.attn.out_proj.bias"], quant)
    h = F.layer_norm(x, (width,), sd[f"{p}.ln_2.weight"],
                     sd[f"{p}.ln_2.bias"], LN_EPS)
    h = linear(h, sd[f"{p}.mlp.c_fc.weight"], sd[f"{p}.mlp.c_fc.bias"], quant)
    h = h * torch.sigmoid(1.702 * h)
    return x + linear(h, sd[f"{p}.mlp.c_proj.weight"],
                      sd[f"{p}.mlp.c_proj.bias"], quant)


def image_features(sd, images, patch, layers, heads, quant=None):
    """images [b, H, W, 3] uint8 -> [b, embed_dim] fp32 (unnormalised)."""
    x = images.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    x, w = _q(quant, x, sd["visual.conv1.weight"])
    x = F.conv2d(x, w, stride=patch)
    b, width = x.shape[:2]
    x = x.reshape(b, width, -1).transpose(1, 2)
    cls = sd["visual.class_embedding"].expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"]
    x = F.layer_norm(x, (width,), sd["visual.ln_pre.weight"],
                     sd["visual.ln_pre.bias"], LN_EPS)
    for i in range(layers):
        x = block(x, sd, f"visual.transformer.resblocks.{i}", heads,
                  quant=quant)
    x = F.layer_norm(x[:, 0], (width,), sd["visual.ln_post.weight"],
                     sd["visual.ln_post.bias"], LN_EPS)
    x, proj = _q(quant, x, sd["visual.proj"])
    return x @ proj


def text_features(sd, tokens, layers, heads, quant=None):
    """tokens [b, context] int64 -> [b, embed_dim] fp32 (unnormalised),
    pooled at the end-of-text token (the highest id of each row)."""
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"]
    n, width = x.shape[1], x.shape[2]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    for i in range(layers):
        x = block(x, sd, f"transformer.resblocks.{i}", heads, mask, quant)
    x = F.layer_norm(x, (width,), sd["ln_final.weight"], sd["ln_final.bias"],
                     LN_EPS)
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    x, proj = _q(quant, x, sd["text_projection"])
    return x @ proj


def softmax_features(image_emb, text_emb, T):
    """softmax(T cos(image, text)) [b, n_text], fp32."""
    i = image_emb / image_emb.norm(dim=-1, keepdim=True)
    t = text_emb / text_emb.norm(dim=-1, keepdim=True)
    return torch.softmax(T * (i @ t.t()), dim=-1)


def fp8_e4m3(x):
    """x rounded to fp8 e4m3 under a per-tensor scale that maps its largest
    magnitude to the format's largest (448), as fp8 products are fed."""
    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


# the control: the nearest precision below the configuration's bf16
CONTROL = fp8_e4m3


def layout(cfg):
    """[(key, shape, std, offset)] of every tensor of the ViT CLIP under
    OpenAI's keys, scaled so that activations stay O(1) through the full
    depth: matrices by the square root of their fan-in, biases at 0.02,
    LayerNorm gains 1 + 0.05 noise."""
    v, t, embed_dim = cfg["vision"], cfg["text"], cfg["embed_dim"]
    out = []

    def mat(key, shape, fan_in):
        out.append((key, shape, fan_in ** -0.5, 0.0))

    def vec(key, n, std=0.02):
        out.append((key, (n,), std, 0.0))

    def ln(prefix, n):
        out.append((f"{prefix}.weight", (n,), 0.05, 1.0))
        vec(f"{prefix}.bias", n)

    def tower(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            ln(f"{p}.ln_1", width)
            ln(f"{p}.ln_2", width)
            mat(f"{p}.attn.in_proj_weight", (3 * width, width), width)
            vec(f"{p}.attn.in_proj_bias", 3 * width)
            mat(f"{p}.attn.out_proj.weight", (width, width), width)
            vec(f"{p}.attn.out_proj.bias", width)
            mat(f"{p}.mlp.c_fc.weight", (4 * width, width), width)
            vec(f"{p}.mlp.c_fc.bias", 4 * width)
            mat(f"{p}.mlp.c_proj.weight", (width, 4 * width), 4 * width)
            vec(f"{p}.mlp.c_proj.bias", width)

    w, g = v["width"], v["image_size"] // v["patch_size"]
    mat("visual.conv1.weight", (w, 3, v["patch_size"], v["patch_size"]),
        3 * v["patch_size"] ** 2)
    vec("visual.class_embedding", w, w ** -0.5)
    mat("visual.positional_embedding", (g * g + 1, w), w)
    ln("visual.ln_pre", w)
    tower("visual.transformer", w, v["layers"])
    ln("visual.ln_post", w)
    mat("visual.proj", (w, embed_dim), w)
    tw = t["width"]
    mat("token_embedding.weight", (t["vocab_size"], tw), tw)
    mat("positional_embedding", (t["context_length"], tw), tw)
    tower("transformer", tw, t["layers"])
    ln("ln_final", tw)
    mat("text_projection", (tw, embed_dim), tw)
    return out


def softmax(cfg, sd, tokens, images, quant=None, block=128):
    """The softmax features [b, n_class] of ``images`` [b, H, W, 3] uint8
    against the prompts ``tokens``, fp32 from the weights ``sd``, in blocks
    of ``block`` images."""
    sd32 = {k: x.float() for k, x in sd.items()}
    v, t = cfg["vision"], cfg["text"]
    with torch.no_grad():
        text = text_features(sd32, tokens, t["layers"], t["heads"], quant)
        out = []
        for s in range(0, images.shape[0], block):
            emb = image_features(sd32, images[s:s + block], v["patch_size"],
                                 v["layers"], v["heads"], quant)
            out.append(softmax_features(emb, text, float(cfg["T"])))
    return torch.cat(out)


def work_counts(cfg, batch_sizes):
    """{image_flops: the image tower's products an image, k4b_bound_s: the
    fused attention's bytes bound over a pass of batches of these sizes}."""
    v = cfg["vision"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    k4b = v["layers"] * sum(work.attention_bytes(b, n, v["width"])
                            for b in batch_sizes)
    return {"image_flops": work.vit_image_flops(
        v["image_size"], v["patch_size"], v["width"], v["layers"],
        cfg["embed_dim"]), "k4b_bound_s": k4b / work.PEAK_BYTES_PER_S}
