#!/usr/bin/env python
"""Convert feature caches between the PyTorch port's store backends
(pickle <-> npz), through transductive_clip_tpu_torch/features/store.py.

    python scripts/convert_feature_cache_torch.py src.plk dst.npz

Reads caches written by either package or by the torch reference. A
``.orbax`` path gets the port's error: that store is declined (its
docstring says why).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from transductive_clip_tpu_torch.features.store import (  # noqa: E402
    _STORES,
    open_store,
)


def kind_of(path):
    for kind, cls in _STORES.items():
        if path.endswith(cls.suffix):
            return kind
    raise SystemExit(f"Unknown cache suffix for {path}; use one of "
                     f"{sorted(set(c.suffix for c in _STORES.values()))}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    src, dst = argv
    features, labels = open_store(kind_of(src)).load(src)
    open_store(kind_of(dst)).save(dst, features, labels)
    print(f"{src} -> {dst}: {features.shape} features, {labels.shape} labels")


if __name__ == "__main__":
    main()
