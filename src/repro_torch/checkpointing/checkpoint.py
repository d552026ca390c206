"""Checkpoint save/restore: flattened-tree npz shards + manifest + hashes.

Counterpart of ``repro.checkpointing.checkpoint``, with its layout, so that a
checkpoint written by either package restores, bitwise, in the other::

    <dir>/step_00000100/
        manifest.json      # leaf paths, shapes, dtypes, sha256 per leaf
        arrays_00000.npz   # <= shard_bytes of leaves each, as raw bytes
        ...

Leaf keys are the dict keys of the path joined by ``/``, in sorted-key
order (JAX's); each leaf is stored as its raw bytes (uint8) with its dtype
name, and hashed (the first 16 hex digits of its sha256). bf16 goes in and
out as its 16-bit pattern, with no ``ml_dtypes``. A tensor leaf restores as
a tensor on its template's device; a Python int (the data cursor) is stored
as numpy stores it (int64) and restores as an int. Writes are atomic (tmp
dir + rename) and optionally asynchronous (``AsyncSaver``: a background
thread; ``wait()`` joins). Restore validates the hashes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import leaves_with_path

_SEP = "/"
# the dtypes a leaf may have, by the name the manifest records; bf16 is held
# in numpy as its 16-bit pattern
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_BITS = {torch.bfloat16: np.uint16}


def _flatten(tree) -> dict[str, Any]:
    """{key: leaf} in sorted-key order, keys joined by ``/``."""
    return {_SEP.join(map(str, path)): leaf
            for path, leaf in leaves_with_path(tree)}


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the leaf's bytes as a numpy array, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _BITS:
            return t.view(torch.int16).numpy().view(_BITS[t.dtype]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def host_tree(tree):
    """The tree with every leaf copied to the host as (bytes, dtype name):
    what ``save`` writes, taken now, so that later in-place updates of the
    tensors do not reach it."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.device.type == "cpu":
        tree = tree.clone()     # .cpu() of a CPU tensor is the tensor itself
    return _host(tree)


def save(tree, directory: str, *, shard_bytes: int = 1 << 30) -> str:
    tmp = directory + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: dict[str, Any] = {"leaves": {}, "shards": []}
    shard: dict[str, np.ndarray] = {}
    size = 0
    sid = 0

    def emit():
        nonlocal shard, size, sid
        if not shard:
            return
        name = f"arrays_{sid:05d}.npz"
        np.savez(os.path.join(tmp, name), **shard)
        manifest["shards"].append(name)
        shard, size, sid = {}, 0, sid + 1

    for key, leaf in _flatten(tree).items():
        arr, dtype = leaf if isinstance(leaf, tuple) else _host(leaf)
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": dtype, "shard": sid,
            "sha": _sha(arr)}
        shard[key] = np.frombuffer(np.ascontiguousarray(arr).tobytes(),
                                   dtype=np.uint8)
        size += arr.nbytes
        if size >= shard_bytes:
            emit()
    emit()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)
    return directory


def _decode(raw: np.ndarray, dtype: str, shape) -> np.ndarray:
    if dtype not in _TORCH:
        raise TypeError(f"checkpoint leaf dtype {dtype!r} is not supported")
    bits = _BITS.get(_TORCH[dtype])
    return raw.view(bits if bits is not None else np.dtype(dtype)).reshape(shape)


def _leaf_like(arr: np.ndarray, dtype: str, template):
    if not isinstance(template, torch.Tensor):
        return arr.item() if isinstance(template, (int, float)) else arr
    if _TORCH[dtype] in _BITS:    # the 16-bit pattern, through int16
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(_TORCH[dtype])
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(template.device)


def restore(tree_like, directory: str, *, validate: bool = True):
    """Restore into the structure of ``tree_like`` (its leaves are
    templates: a tensor's device is kept, an int stays an int)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    arrays: dict[str, np.ndarray] = {}
    for name in manifest["shards"]:
        with np.load(os.path.join(directory, name)) as z:
            for k in z.files:
                arrays[k] = z[k]
    decoded: dict[str, tuple[np.ndarray, str]] = {}
    for key, meta in manifest["leaves"].items():
        arr = _decode(arrays[key], meta["dtype"], meta["shape"])
        if validate and _sha(arr) != meta["sha"]:
            raise IOError(f"checkpoint corruption at leaf {key!r}")
        decoded[key] = (arr, meta["dtype"])

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        key = _SEP.join(prefix)
        if key not in decoded:
            raise KeyError(f"missing leaf {key!r} in checkpoint {directory}")
        return _leaf_like(*decoded[key], tree)

    return build(tree_like)


class AsyncSaver:
    """Background-thread checkpoint writer (keeps the train loop hot). The
    tree is copied to the host before ``submit`` returns."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def submit(self, tree, directory: str):
        self.wait()
        snapshot = host_tree(tree)

        def work():
            try:
                save(snapshot, directory)
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
