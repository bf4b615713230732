"""The extraction cells' inputs, made on the card from the seed: CLIP
weights under OpenAI's state-dict keys, the class prompts' token ids and
the uint8 images.

The weights come from one draw of normal numbers, cut into the tensors that
the configuration's reference lays out (``layout`` of
benchmark/reference/<reference>.py) and scaled there. They are kept in bf16, the type the towers serve in, and handed to
the program and to the reference alike."""

from __future__ import annotations

import math

import numpy as np
import torch

SOT, EOT = 49406, 49407


def generator(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0]))
    return g


def state_dict(cfg, layout, seed, device, dtype=torch.bfloat16):
    """{OpenAI key: tensor on the card} for the configuration ``cfg``, laid
    out by its reference's ``layout(cfg)``: [(key, shape, std, offset)]."""
    layout = layout(cfg)
    total = sum(math.prod(s) for _, s, _, _ in layout)
    noise = torch.randn(total, generator=generator(seed, 0, device),
                        device=device)
    sd, at = {}, 0
    for key, shape, std, offset in layout:
        n = math.prod(shape)
        sd[key] = (noise[at:at + n].view(shape) * std + offset).to(dtype)
        at += n
    del noise
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device,
                                     dtype=dtype)
    return sd


def prompt_tokens(seed, n_prompts, context, vocab, device):
    """[n_prompts, context] token ids like the tokenizer's: start-of-text,
    3 to 20 word pieces, end-of-text (the highest id), zeros after."""
    g = generator(seed, 1, device)
    lengths = torch.randint(3, 21, (n_prompts,), generator=g, device=device)
    words = torch.randint(0, vocab - 2, (n_prompts, context), generator=g,
                          device=device)
    pos = torch.arange(context, device=device)
    tokens = torch.where(pos <= lengths[:, None], words, 0)
    tokens[:, 0] = SOT
    tokens[torch.arange(n_prompts, device=device), lengths + 1] = EOT
    return tokens


def images(seed, n, size, device):
    """[n, size, size, 3] uint8 pixels."""
    return torch.randint(0, 256, (n, size, size, 3), generator=generator(
        seed, 2, device), device=device, dtype=torch.uint8)
