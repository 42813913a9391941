"""Carrying state across between the JAX package and the port.

``from_numpy`` turns a pytree of numpy arrays (e.g. a JAX game state or a
whole session carry after ``jax.device_get``) into the port's tensors, leaf
for leaf; ``to_numpy`` turns the port's back.  Both packages can then start
from the same state, and their carries compare leaf for leaf.

torch's ``uint32`` has no arithmetic, so u32 leaves become ``int32`` tensors
of the same bit pattern.  On the way back, the carry's digest leaves
(``hist`` and the ring's ``checksums``, the only u32 leaves either package's
carry holds) are returned as ``uint32``, as the JAX package holds them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.device import DeviceLike, resolve_device
from .utils.tree import tree_map

DIGEST_KEYS = ("hist", "checksums")


def _host_tensor(leaf: Any) -> torch.Tensor:
    arr = np.array(leaf)  # copies: device_get's arrays are read-only
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Pytree of numpy arrays (or scalars, or tensors) -> pytree of tensors on
    ``device``; dict keys come back sorted, as ``jax.tree_util`` orders them.

    Host arrays bound for a CUDA device are copied into pinned memory and
    sent with ``non_blocking=True``, so they never make the host wait for
    the card; PyTorch's caching host allocator keeps the pinned block until
    its copy has completed.  Tensors are moved with ``.to(device)``."""
    dev = resolve_device(device)

    def conv(leaf: Any, _key: Any) -> torch.Tensor:
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dev)
        t = _host_tensor(leaf)
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    return _map(conv, tree)


def host_tensors(tree: Any) -> Any:
    """Pytree of numpy arrays (or scalars, or tensors) -> the host tensors
    ``from_numpy`` would send (u32 as int32 bit patterns); tensors pass
    through."""
    return _map(lambda leaf, _key: leaf if isinstance(leaf, torch.Tensor) else _host_tensor(leaf),
                tree)


def copy_into(dst: Any, tree: Any) -> None:
    """Copy ``tree`` (host tensors from ``host_tensors``, or tensors) into
    the tensors ``dst`` of the same structure and shapes, in place, one
    copy per leaf.  A host leaf bound for a CUDA tensor goes from a fresh
    pinned block with ``non_blocking=True``, as ``from_numpy`` sends it:
    the caching host allocator keeps the block until its copy completes."""

    def copy(d: torch.Tensor, leaf: torch.Tensor) -> None:
        if d.device.type == "cuda" and leaf.device.type == "cpu":
            d.copy_(leaf.pin_memory(), non_blocking=True)
        else:
            d.copy_(leaf)

    tree_map(copy, dst, tree)


def to_numpy(tree: Any) -> Any:
    """Pytree of tensors (or numpy arrays) -> pytree of numpy arrays on the
    host; int32 leaves under a ``DIGEST_KEYS`` key come back as ``uint32``."""

    def conv(leaf: Any, key: Any) -> np.ndarray:
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if key in DIGEST_KEYS and arr.dtype == np.int32:
            arr = arr.view(np.uint32)
        return arr

    return _map(conv, tree)


def _map(fn, tree: Any, key: Any = None) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], k) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, key) for t in tree)
    return fn(tree, key)
