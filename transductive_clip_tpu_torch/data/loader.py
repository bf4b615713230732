"""Host-side image batching for feature extraction: threaded decode +
preprocess feeding stacked numpy batches to the towers (the port's own copy
of transductive_clip_tpu/data/loader.py; PIL is imported only inside
``read_image``; reference: src/datasets/utils.py:266-341 — the reference decodes
single-threaded with ``num_workers=0`` and retries failed reads forever;
here decode is threaded and the retry is bounded).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_READ_RETRIES = 5


def read_image(path, retries: int = _READ_RETRIES):
    """Open an image, retrying transient IO errors a bounded number of
    times (the reference loops forever on any exception,
    src/datasets/utils.py:23-31)."""
    from PIL import Image

    last = None
    for attempt in range(retries):
        try:
            with Image.open(path) as img:
                return img.convert("RGB")
        except OSError as e:
            last = e
            time.sleep(0.05 * (attempt + 1))
    raise OSError(
        f"Cannot read image from {path} after {retries} attempts"
    ) from last


def iter_image_batches(data, preprocess=None, batch_size: int = 512,
                       num_threads: int = 16):
    """Yield ``(images, labels)`` batches from a list of ``Datum``.

    ``images`` is ``[b, H, W, 3]`` float32 (CLIP-normalized) or uint8,
    depending on the preprocess fn; ``labels`` is ``[b]`` int64. Decode +
    preprocess run in a thread pool (PIL releases the GIL during decode),
    so the host pipeline keeps up with the device encode it feeds.
    """
    if preprocess is None:
        from ..models.clip.preprocess import make_preprocess

        preprocess = make_preprocess()

    def decode(datum):
        return preprocess(read_image(datum.impath))

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for start in range(0, len(data), batch_size):
            chunk = data[start:start + batch_size]
            images = list(pool.map(decode, chunk))
            labels = np.array([d.label for d in chunk], np.int64)
            yield np.stack(images), labels
