"""Feature extraction glue (counterpart of
transductive_clip_tpu/eval/extraction.py; reference: src/utils.py:251-377):
makes sure the feature caches of the requested splits exist, running the
CLIP towers over the dataset when one is missing.

Kept apart from the evaluators, so that cache-only runs never import the
model or data layers. :func:`extract_to_caches` is the part after the
decode (encode the batches, normalize, write one cache per temperature); it
takes any iterable of ``(uint8 or float32 NHWC batch, labels)``.

With ``data_parallel`` and a task group (parallel/) extraction is
batch-data-parallel: each rank encodes its share of every image batch
(``TorchCLIP.set_task_group``), every rank gets the whole batch's
embeddings, rank 0 writes the caches and the ranks wait for it. Every
rank of the world takes a share, whatever the group's ``tp``: the JAX
package extracts on ``make_mesh(tp=1)``. The text prototypes are computed
on every rank (identical, so nothing is exchanged) and written by rank 0.

:func:`extract_to_caches` makes its own ``PhaseTimer`` the active one
(core/profiling.py) around its body and logs its summary: span
``extract.encode`` (the host issuing every batch's towers; once the card
is a launch queue behind, the host waits inside it at the card's pace),
span ``extract.first_issue`` (the host issuing a pass's first batch, with
nothing of the pass queued ahead of it: the host's own issue time of a
batch), the fetch's ``host_wait`` (``to_host``), span ``extract.softmax``
(the host normalisation, then each target's softmax, one record each),
counters ``extract.batches`` and ``extract.images``.
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch

from ..core.profiling import PhaseTimer, count, span
from ..features.cache import (
    save_feature_cache,
    softmax_cache_path,
    visual_cache_path,
)
from ..ops.common import to_host
from ..parallel import barrier, class_layout

_log = logging.getLogger(__name__)


def _require_model(model, what):
    if model is None:
        raise ValueError(
            f"{what} requires a CLIP model but none was loaded. "
            "Either provide cached features under data/<dataset>/saved_features/ "
            "or load a model (see transductive_clip_tpu_torch.models.clip.load)."
        )


def text_cache_path(args):
    """Cache path of the text prototypes (shared with the CLI's need-model
    check, so the two never disagree)."""
    safe_backbone = str(args.backbone).replace("/", "")
    return os.path.join(
        getattr(args, "root", "data"), args.dataset, "saved_features",
        f"text_{safe_backbone}.plk",
    )


def get_text_features(args, model, classnames=None, template=None,
                      group=None):
    """L2-normalized CLIP text prototypes [n_class, embed_dim] (numpy fp32)
    for the dataset's classnames (reference: src/utils.py:363-377). Cached
    per dataset and backbone. Under a task ``group`` every rank computes
    them and rank 0 writes the cache, once every rank has looked for it."""
    cache = text_cache_path(args)
    if os.path.exists(cache):
        from ..core.io import load_pickle

        return np.asarray(load_pickle(cache)["text_features"], np.float32)

    _require_model(model, "Computing text features")
    if classnames is None or template is None:
        from ..data import build_dataset

        dataset = build_dataset(args.dataset, args.dataset_path)
        classnames, template = dataset.classnames, dataset.template
    prompts = [template.format(c.replace("_", " ")) for c in classnames]
    text_features = np.array(to_host(model.encode_text_prompts(prompts)),
                             np.float32)
    text_features /= np.linalg.norm(text_features, axis=-1, keepdims=True)

    from ..core.io import save_pickle

    barrier(group)
    if group is None or group.rank == 0:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        save_pickle(cache, {"text_features": text_features})
    return text_features


def extract_to_caches(model, batches, targets, text_features=None,
                      write=True):
    """Encode every ``(images, labels)`` batch, then write one cache per
    ``(T, path)`` of ``targets``: the L2-normalized embeddings for
    ``T=None``, else ``softmax(T * embeddings @ text_features^T)`` (host
    fp32, in place). The embeddings stay on the device until the last batch
    is dispatched and come to the host in one transfer. Returns
    (normalized embeddings [N, embed_dim], labels [N]) as numpy;
    ``write=False`` writes no cache."""
    timer = PhaseTimer()
    with timer.active():
        pending, labels = [], []
        with span("extract.encode"):
            for images, batch_labels in batches:
                first = (span("extract.first_issue") if not pending
                         else contextlib.nullcontext())
                with first:
                    pending.append(model.encode_image_batch(images))
                labels.append(np.asarray(batch_labels))
                count("extract.batches")
                count("extract.images", len(labels[-1]))
        fetched = to_host(torch.cat(pending))
        with span("extract.softmax"):
            embeddings = np.array(fetched, np.float32)
            embeddings /= np.linalg.norm(embeddings, axis=-1, keepdims=True)
        all_labels = np.concatenate(labels)
        for T, path in targets:
            if T is None:
                out = embeddings
            else:
                with span("extract.softmax"):
                    # in place: one [N, n_class] buffer instead of three
                    out = embeddings @ text_features.T
                    out *= T
                    out -= out.max(axis=-1, keepdims=True)
                    np.exp(out, out=out)
                    out /= out.sum(axis=-1, keepdims=True)
            if write:
                save_feature_cache(path, out, all_labels)
    _log.info("extraction phase timing -- " + timer.summary())
    return embeddings, all_labels


def ensure_features(args, model, preprocess=None, splits=("test",),
                    list_T=None, group=None):
    """Extract and cache features for each split whose cache is missing.

    ``list_T`` writes softmax features for several temperatures from one
    pass over the images (reference: src/utils.py:251-264); defaults to
    [args.T]. With ``data_parallel: True`` and a task ``group`` every rank
    calls this, the image batches are encoded batch-data-parallel and rank
    0 writes the caches (module docstring); without a group (one device)
    it is the single-device path."""
    from .zero_shot import _parse_flag

    root = getattr(args, "root", "data")
    store = str(args.get("feature_store", "plk"))
    if list_T is None:
        list_T = [args.T]
    missing = []
    for split in splits:
        if args.use_softmax_feature:
            for T in list_T:
                path = softmax_cache_path(args.dataset, split, args.backbone,
                                          T, root=root, store=store)
                if not os.path.exists(path):
                    missing.append((split, T, path))
        else:
            path = visual_cache_path(args.dataset, split, args.backbone,
                                     root=root, store=store)
            if not os.path.exists(path):
                missing.append((split, None, path))
    if not missing:
        return

    _require_model(model, "Feature extraction")
    if not _parse_flag(args.get("data_parallel", False), "data_parallel"):
        group = None
    # every rank on the task axis, whatever the evaluation's tp: the JAX
    # package extracts on make_mesh(tp=1)
    group = class_layout(group, 1)
    model.set_task_group(group)
    # every rank has looked for the caches before rank 0 writes any
    barrier(group)
    from ..data import build_dataset, iter_image_batches

    dataset = build_dataset(args.dataset, args.dataset_path)
    text_features = None
    if args.use_softmax_feature:
        text_features = get_text_features(
            args, model, dataset.classnames, dataset.template, group=group
        )
    split_sources = {
        "train": dataset.train_x,
        "val": dataset.val,
        "test": dataset.test,
    }
    # one image pass per split, every temperature from the same embeddings
    by_split = {}
    for split, T, path in missing:
        by_split.setdefault(split, []).append((T, path))
    for split, targets in by_split.items():
        batches = iter_image_batches(
            split_sources[split], preprocess=preprocess,
            batch_size=getattr(args, "extract_batch_size", 512),
        )
        extract_to_caches(model, batches, targets, text_features,
                          write=group is None or group.rank == 0)
    barrier(group)
