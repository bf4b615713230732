"""Data layer: the 11 protocol datasets, split bookkeeping, and the
host-side image batching pipeline (the port's own copy of
transductive_clip_tpu/data/; reference: src/datasets/). PIL is imported
only when an image is read."""

from .base import Datum, DatasetBase, generate_fewshot_subset
from .loader import iter_image_batches, read_image
from .registry import DATASET_REGISTRY, build_dataset

__all__ = [
    "Datum",
    "DatasetBase",
    "DATASET_REGISTRY",
    "build_dataset",
    "generate_fewshot_subset",
    "iter_image_batches",
    "read_image",
]
