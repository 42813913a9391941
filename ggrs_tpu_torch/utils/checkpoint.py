"""Durable checkpoints for device sessions, in the JAX package's file format.

The port of ``ggrs_tpu/utils/checkpoint.py``: one ``.npz`` (written with
``np.savez_compressed``) holding the tree's leaves as ``leaf_{i}`` in
``jax.tree_util`` order (dict keys sorted) and a JSON metadata record under
``__meta__``.  Loading validates the leaf count, shapes and dtypes against
a template, so a file written by either package loads into the other.

torch has no u32 arithmetic, so the port holds u32 leaves as int32 tensors
of the same bits (``convert.py``).  A file holds the carry's digest leaves
as ``uint32``, as the JAX package writes them (``to_numpy`` restores the
type), and an int32 template leaf takes a ``uint32`` file leaf.  Loaded
leaves come back as numpy arrays with the file's dtypes; ``convert.
from_numpy`` turns them into the port's tensors.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..convert import to_numpy
from .tree import tree_leaves, tree_map


def _normalize(path) -> str:
    """np.savez appends ``.npz`` to extension-less paths; normalize here so
    save and load agree on the file name."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _write(target, tree: Any, meta: Dict[str, Any]) -> None:
    leaves = tree_leaves(to_numpy(tree))
    arrs = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    np.savez_compressed(target, __meta__=np.asarray(json.dumps(meta)), **arrs)


def _ref_dtype(ref: Any) -> np.dtype:
    if isinstance(ref, torch.Tensor):
        return torch.empty(0, dtype=ref.dtype).numpy().dtype
    return np.dtype(getattr(ref, "dtype", type(ref)))


def _read(npz, template: Any, expects: str) -> Tuple[Any, Dict[str, Any]]:
    meta = json.loads(str(npz["__meta__"][()]))
    refs = tree_leaves(template)
    n_saved = sum(1 for k in npz.files if k.startswith("leaf_"))
    if n_saved != len(refs):
        raise ValueError(
            f"checkpoint holds {n_saved} leaves, {expects} expects "
            f"{len(refs)} — wrong session config for this checkpoint?"
        )
    loaded: List[np.ndarray] = []
    for i, ref in enumerate(refs):
        arr = npz[f"leaf_{i}"]
        ref_shape = tuple(np.shape(ref))
        ref_dtype = _ref_dtype(ref)
        dtype_ok = arr.dtype == ref_dtype or (arr.dtype == np.uint32 and ref_dtype == np.int32)
        if arr.shape != ref_shape or not dtype_ok:
            raise ValueError(
                f"checkpoint leaf {i} is {arr.dtype}{arr.shape}, {expects} "
                f"expects {ref_dtype}{ref_shape} — wrong session config "
                "for this checkpoint?"
            )
        loaded.append(arr)
    it = iter(loaded)
    return tree_map(lambda _ref: next(it), template), meta


def save_pytree(path, tree: Any, meta: Dict[str, Any]) -> None:
    """Write a tree's leaves (fetched to the host) and JSON metadata to ``path``."""
    _write(_normalize(path), tree, meta)


def dumps_pytree(tree: Any, meta: Dict[str, Any]) -> bytes:
    """:func:`save_pytree` into bytes: one self-contained npz blob."""
    buf = io.BytesIO()
    _write(buf, tree, meta)
    return buf.getvalue()


def loads_pytree(data: bytes, template: Any) -> Tuple[Any, Dict[str, Any]]:
    """Inverse of :func:`dumps_pytree`: the leaves in ``template``'s
    structure, with the same validation as :func:`load_pytree`."""
    with np.load(io.BytesIO(data), allow_pickle=False) as npz:
        return _read(npz, template, "template")


def load_pytree(path, template: Any) -> Tuple[Any, Dict[str, Any]]:
    """Read leaves saved by :func:`save_pytree` back into ``template``'s
    structure (shapes and dtypes must match) and return ``(tree, meta)``."""
    with np.load(_normalize(path), allow_pickle=False) as npz:
        return _read(npz, template, "session")
