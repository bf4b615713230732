"""Dataset registry: config `dataset` name -> loader (the port's own copy
of transductive_clip_tpu/data/registry.py; reference:
src/eval_zero_shot.py:22-34)."""

from __future__ import annotations

import functools

from .catalog import COOP_SPECS, CoopJsonDataset, ImageNet, FGVCAircraft

DATASET_REGISTRY = {
    **{
        name: functools.partial(CoopJsonDataset, name)
        for name in COOP_SPECS
    },
    "fgvcaircraft": FGVCAircraft,
    "imagenet": ImageNet,
}


def build_dataset(name: str, root: str):
    try:
        builder = DATASET_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown dataset {name!r}; choose from {sorted(DATASET_REGISTRY)}"
        ) from None
    return builder(root)
