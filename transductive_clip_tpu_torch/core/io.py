"""Pickle helpers for the feature cache (reference: src/utils.py:241-248).

Stored payloads are plain numpy arrays so caches are portable and do not
require torch to read. Caches written by the torch reference implementation
(``pickle.dump`` of dicts holding ``torch.Tensor``) load either way:

* torch importable — the normal unpickler materializes real tensors and
  ``_to_numpy`` converts them;
* torch absent (a production install: torch is a test-only extra in
  pyproject.toml) — ``_TorchFreeUnpickler`` resolves the torch
  reconstruction globals (``torch._utils._rebuild_tensor_v2``,
  ``torch.storage._load_from_bytes``, the ``torch.*Storage`` classes) to
  numpy-native equivalents, parsing the legacy ``torch.save`` byte payload
  each storage carries (magic/protocol/sys-info pickles, a persistent-id
  stub for the storage, then ``int64 numel`` + raw little-endian data).
"""

from __future__ import annotations

import io
import pickle
import struct

import numpy as np


def save_pickle(file: str, data) -> None:
    with open(file, "wb") as f:
        pickle.dump(data, f)


def _to_numpy(x):
    if isinstance(x, np.ndarray):
        return x
    # torch tensors from caches written by the reference implementation
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- torch-free unpickling of reference-written tensor caches ---------------

#: torch storage class name -> numpy dtype of the raw storage payload
_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "BFloat16Storage": np.dtype("<u2"),  # converted to float32 below
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("<i1"),
    "ByteStorage": np.dtype("<u1"),
    "BoolStorage": np.dtype("?"),
    "UntypedStorage": np.dtype("<u1"),
}

_TORCH_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C


class _StorageTypeStub:
    """Stands in for a ``torch.FloatStorage``-style class during torch-free
    unpickling; only its dtype is ever used (inside the persistent-id
    tuple of the legacy storage payload)."""

    def __init__(self, name: str):
        self.name = name
        self.dtype = _STORAGE_DTYPES[name]


class _NumpyStorage:
    """A parsed torch storage: a flat 1-D numpy array in its FINAL dtype
    (bfloat16 payloads are widened to float32 here, so downstream stride
    arithmetic — which torch expresses in elements, not bytes — stays
    valid)."""

    def __init__(self, array: np.ndarray):
        self.array = array


def _torch_legacy_storage_from_bytes(b: bytes) -> _NumpyStorage:
    """Torch-free ``torch.storage._load_from_bytes``.

    The bytes are a legacy-format ``torch.save`` of exactly one storage
    (torch's ``TypedStorage.__reduce__`` pins
    ``_use_new_zipfile_serialization=False``): three header pickles (magic
    number, protocol version, sys info), the storage object pickled as a
    persistent id ``('storage', storage_class, key, location, numel, ...)``,
    the serialized-keys list, then per key an ``int64`` element count
    followed by the raw little-endian buffer.
    """
    f = io.BytesIO(b)
    magic = pickle.load(f)
    if magic != _TORCH_LEGACY_MAGIC:
        raise ValueError(
            f"not a legacy torch storage payload (magic {magic:#x})"
        )
    pickle.load(f)  # protocol version
    pickle.load(f)  # sys info (endianness/type sizes; assumed little-endian)

    class _StoragePidUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch" and name in _STORAGE_DTYPES:
                return _StorageTypeStub(name)
            return super().find_class(module, name)

        def persistent_load(self, pid):
            return pid

    pid = _StoragePidUnpickler(f).load()
    if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
        raise ValueError(f"unexpected storage persistent id: {pid!r}")
    stub = pid[1]
    if not isinstance(stub, _StorageTypeStub):
        raise ValueError(f"unexpected storage class in pid: {stub!r}")
    keys = pickle.load(f)
    if len(keys) != 1:
        raise ValueError(f"expected one storage key, got {keys!r}")
    numel = struct.unpack("<q", f.read(8))[0]
    raw = f.read(numel * stub.dtype.itemsize)
    if len(raw) != numel * stub.dtype.itemsize:
        raise ValueError("truncated storage payload")
    arr = np.frombuffer(raw, dtype=stub.dtype).copy()
    if stub.name == "BFloat16Storage":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return _NumpyStorage(arr)


def _rebuild_tensor_numpy(storage, storage_offset, size, stride, *unused):
    """Torch-free ``torch._utils._rebuild_tensor{,_v2}``: materialize the
    (possibly strided / offset) view as a contiguous numpy array. torch
    strides are in elements; numpy's are in bytes."""
    arr = storage.array
    if not size:  # 0-d tensor
        return arr[storage_offset].copy()
    view = np.lib.stride_tricks.as_strided(
        arr[storage_offset:],
        shape=tuple(int(s) for s in size),
        strides=tuple(int(s) * arr.itemsize for s in stride),
    )
    return np.ascontiguousarray(view)


class _TorchFreeUnpickler(pickle.Unpickler):
    """Unpickles reference-written caches on installs without torch by
    rerouting torch's tensor-reconstruction globals to numpy."""

    def find_class(self, module, name):
        if module == "torch._utils" and name in (
            "_rebuild_tensor_v2",
            "_rebuild_tensor",
        ):
            return _rebuild_tensor_numpy
        if module == "torch.storage" and name == "_load_from_bytes":
            return _torch_legacy_storage_from_bytes
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageTypeStub(name)
        if module == "torch" and name == "Size":
            return tuple
        return super().find_class(module, name)


def load_pickle(file: str):
    with open(file, "rb") as f:
        try:
            data = pickle.load(f)
        except ImportError as e:
            # torch-written cache on a torch-free install: re-read with the
            # torch globals rerouted to numpy reconstruction
            if "torch" not in str(e):
                raise
            f.seek(0)
            data = _TorchFreeUnpickler(f).load()
    if isinstance(data, dict):
        return {k: _to_numpy(v) if not isinstance(v, (str, int, float)) else v for k, v in data.items()}
    return data
