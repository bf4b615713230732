"""Feature cache.

The cache is the framework's checkpoint system (as in the reference, where
rerun skips straight to loading — reference: src/utils.py:266-271). Layout
and naming match the reference so existing caches are reusable:

    data/<dataset>/saved_features/{set}_softmax_{backbone}_T{T}.plk
    data/<dataset>/saved_features/{set}_visual_{backbone}.plk

Payload: {'concat_features': [N, K or D] float32, 'concat_labels': [N]}.
Files written by the torch reference (torch tensors) load transparently.
"""

from __future__ import annotations

import os


# config `feature_store` -> cache filename suffix (features/store.py).
# 'pickle' is the alias store.py's open_store also accepts.
_SUFFIXES = {"plk": ".plk", "pickle": ".plk", "npz": ".npz",
             "orbax": ".orbax"}


def _ext(store):
    try:
        return _SUFFIXES[store]
    except KeyError:
        raise ValueError(
            f"Unknown feature_store {store!r}; choose from {sorted(_SUFFIXES)}"
        ) from None


def softmax_cache_path(dataset, set_name, backbone, T, root="data",
                       store="plk"):
    # the RAW backbone string is embedded, slash and all: 'ViT-B/16' nests
    # a directory exactly like the reference's format() does
    # (reference: src/utils.py:266-267) — required for existing reference
    # caches to resolve; save paths makedirs so writes work too
    return os.path.join(
        root, dataset, "saved_features",
        f"{set_name}_softmax_{backbone}_T{T}{_ext(store)}",
    )


def visual_cache_path(dataset, set_name, backbone, root="data", store="plk"):
    return os.path.join(
        root, dataset, "saved_features",
        f"{set_name}_visual_{backbone}{_ext(store)}",
    )


def load_feature_cache(path):
    """Returns (features [N, d] float32 ndarray, labels [N] int64 ndarray).

    Pure suffix dispatch: the store backends (features/store.py) own the
    read/write bodies, so there is no cache<->store delegation cycle."""
    from .store import store_for_path

    return store_for_path(path).load(path)


def save_feature_cache(path, features, labels):
    from .store import store_for_path

    return store_for_path(path).save(path, features, labels)
