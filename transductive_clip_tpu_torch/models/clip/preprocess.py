"""Host-side image preprocessing matching CLIP's eval transform:
resize (bicubic, short side = image_size), center crop, scale to [0, 1],
normalize with CLIP statistics (the port's own copy of
transductive_clip_tpu/models/clip/preprocess.py). Output is NHWC; PIL is
imported only when a preprocess function is made.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def resize_crop_geometry(w: int, h: int, image_size: int):
    """The reference transform chain's exact geometry (torchvision
    semantics, reference: src/datasets/utils.py:266-313 via clip.load):

    * Resize(int): short side -> ``image_size``, long side scaled with
      ``int()`` TRUNCATION (torchvision ``_compute_resized_output_size``);
    * CenterCrop: offset ``int(round(d / 2.0))`` with Python's
      round-half-to-even — one pixel off from ``d // 2`` when d % 4 == 3.

    Returns (new_w, new_h, left, top) for a (w, h) input.
    """
    if w <= h:
        new_w, new_h = image_size, int(image_size * h / w)
    else:
        new_w, new_h = int(image_size * w / h), image_size
    left = int(round((new_w - image_size) / 2.0))
    top = int(round((new_h - image_size) / 2.0))
    return new_w, new_h, left, top


def make_preprocess(image_size: int = 224, dtype: str = "float32"):
    """dtype="uint8" defers scaling/normalization to the device: the encoder
    normalizes uint8 inputs on the card, and the host->device transfer is
    4x smaller."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ImportError("PIL is required for image preprocessing") from e

    def preprocess(img) -> np.ndarray:
        """PIL image -> [H, W, 3] (uint8 raw, or float32 CLIP-normalized)."""
        w, h = img.size
        new_w, new_h, left, top = resize_crop_geometry(w, h, image_size)
        img = img.resize((new_w, new_h), Image.BICUBIC)
        img = img.crop((left, top, left + image_size, top + image_size))
        arr = np.asarray(img.convert("RGB"), np.uint8)
        if dtype == "uint8":
            return arr
        arr = arr.astype(np.float32) / 255.0
        return (arr - CLIP_MEAN) / CLIP_STD

    return preprocess
