"""Synthetic CLIP softmax feature tables, made on the card.

A stand-in for a zero-shot CLIP feature cache (no cache is in the
repository): every class has a text embedding, every image an embedding
near its class's, and a row is the softmax of ``T`` times the image's
cosine similarity to every class's text embedding, as the program's
extraction writes it. The text embeddings come in groups of
``group_size`` classes whose embeddings share a direction (cosine
``group_corr`` between two of a group), as ImageNet's fine-grained classes
do (dog breeds, snakes): an image is confused mostly with its group's
other classes. An image's embedding is its class's plus isotropic noise of
norm about ``noise`` (as a multiple of the class embedding's), so that the
own class's cosine sits near 0.3, as CLIP's does. ``group_corr`` and
``noise`` set the share of rows whose largest entry is their own class,
the zero-shot accuracy (benchmark/configs/ states the value and what it
reads).

The class embeddings are drawn from the configuration's ``data_seed``, so
every split shares them; each split's image embeddings come from a
generator of their own."""

from __future__ import annotations

import numpy as np
import torch

CHUNK_ROWS = 1 << 17


def split_generator(seed, split, device):
    """A torch generator on the card for one split of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, split]).generate_state(
        1, np.uint64)[0]))
    return g


def class_embeddings(spec, n_class, seed, device):
    """[n_class, embed_dim] unit text embeddings, ``group_size`` classes a
    group around a shared direction."""
    g = split_generator(seed, 100, device)
    d, group = int(spec["embed_dim"]), int(spec["group_size"])
    rho = float(spec["group_corr"])
    centres = torch.randn((-(-n_class // group), d), generator=g,
                          device=device)
    own = torch.randn((n_class, d), generator=g, device=device)
    groups = torch.arange(n_class, device=device) // group
    # cosine rho between two classes of a group: |centre|^2 / (|centre|^2
    # + beta^2 |own|^2) with |centre| ~ |own|
    beta = ((1.0 - rho) / rho) ** 0.5
    t = centres[groups] + beta * own
    return t / t.norm(dim=1, keepdim=True)


def softmax_table(spec, text, split_seed, per_class, T, device):
    """(features [n_class * per_class, n_class] float32 on the host, labels
    [n_class * per_class] int64): ``per_class`` rows a class, in class
    order, made on the card in chunks of rows."""
    n_class, d = text.shape
    g = split_generator(split_seed[0], split_seed[1], device)
    labels = torch.arange(n_class, device=device).repeat_interleave(per_class)
    # pageable host memory, as a cache loaded from a file is
    out = torch.empty((labels.numel(), n_class), dtype=torch.float32)
    scale = float(spec["noise"]) / d ** 0.5
    for s in range(0, labels.numel(), CHUNK_ROWS):
        lab = labels[s:s + CHUNK_ROWS]
        x = text[lab] + scale * torch.randn((lab.numel(), d), generator=g,
                                            device=device)
        x /= x.norm(dim=1, keepdim=True)
        out[s:s + lab.numel()].copy_(torch.softmax(T * (x @ text.T), dim=1))
    return out.numpy(), labels.cpu().numpy()
