"""On-device state checksums, bit-identical to the JAX package's.

The digest is the 4-lane position-sensitive u32 digest of
``ggrs_tpu/ops/checksum.py``: every leaf of the state (in ``jax.tree_util``
order, dict keys sorted) is bitcast to u32 words, all words are digested as
one logical vector with 1-based global positions, and a structure salt from
the leaf shapes and dtypes is mixed in.  The lanes compose into one u128 on
the host for the wire.

Differences of form, none of value:

- ``checksum_device`` is batch-aware: state leaves carry a leading session
  axis ``(B, ...)`` and the result is ``(B, 4)``.  It is ONE
  ``digest.state_digest`` call: on the card one kernel launch reads every
  leaf in place and writes the salted digests; on the CPU the plain version
  packs, concatenates and mixes (``checksum_device_plain`` takes that path
  on any device).
- digests are ``int32`` tensors holding the u32 bit patterns (torch's
  ``uint32`` has no shifts, sums or ``arange``); compare them as numpy
  ``uint32``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..utils.tree import tree_leaves, tree_map, writing_into
from .digest import (
    MASK32,
    PRIME_B,
    as_u32_words,
    lane_sums_rows_plain,
    state_digest,
    state_digest_plain,
    u32_to_i32,
)

CHECKSUM_LANES = 4

_GOLDEN = 2654435761  # Knuth multiplicative constant

_INIT_LANES = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)

# numpy's (dtype.kind, itemsize) for each torch dtype: the structure salt
# reads them, so the port must see the same values jax's numpy dtypes give
_NP_KIND = {
    torch.bool: ("b", 1),
    torch.uint8: ("u", 1),
    torch.int8: ("i", 1),
    torch.uint16: ("u", 2),
    torch.int16: ("i", 2),
    torch.float16: ("f", 2),
    torch.bfloat16: ("V", 2),  # ml_dtypes' bfloat16 is a void-kind dtype
    torch.uint32: ("u", 4),
    torch.int32: ("i", 4),
    torch.float32: ("f", 4),
    torch.uint64: ("u", 8),
    torch.int64: ("i", 8),
    torch.float64: ("f", 8),
}

# the byte view the kernel reads in place; bitwise the JAX _as_u32_words
_as_u32_words = as_u32_words


def _leaf_shape_key(x: torch.Tensor) -> Tuple[Tuple[int, ...], torch.dtype]:
    return tuple(x.shape[1:]), x.dtype


def _structure_salt(leaves: List[Tuple[Tuple[int, ...], torch.dtype]]) -> np.ndarray:
    """A (4,) u32 constant mixed from the pytree's STATIC structure: leaf
    count, per-leaf word counts and numpy dtype kinds.  ``leaves`` are
    ``(per-session shape, dtype)`` pairs.  Same arithmetic as the JAX
    package's ``_structure_salt``."""
    mask = MASK32
    golden, prime_b = _GOLDEN, PRIME_B
    acc = len(leaves) & mask
    for shape, dtype in leaves:
        kind, nbytes = _NP_KIND[dtype]
        nwords = (math.prod(shape) * nbytes + 3) // 4
        acc = (acc * golden + nwords) & mask
        acc ^= acc >> 15
        acc = (acc * prime_b + ord(kind) * 256 + nbytes) & mask
    lanes = np.empty(CHECKSUM_LANES, np.uint32)
    for i in range(CHECKSUM_LANES):
        acc = (acc * golden + i + 1) & mask
        acc ^= acc >> 13
        lanes[i] = acc
    return lanes


@functools.lru_cache(maxsize=64)
def _salt_mix(structure: Tuple) -> Tuple[int, int, int, int]:
    """``salt * GOLDEN mod 2^32`` as four ints, built once per structure: the
    kernel takes them as launch arguments, so the per-frame digest copies
    nothing from the host."""
    salt = _structure_salt(list(structure))
    return tuple((int(s) * _GOLDEN) & MASK32 for s in salt)


def _digest(state: Any, device: DeviceLike, digest,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    leaves = tree_leaves(state)
    if not leaves:
        init = torch.tensor(_INIT_LANES, dtype=torch.int64, device=resolve_device(device))
        init = u32_to_i32(init).reshape(1, CHECKSUM_LANES)
        return init if out is None else out.copy_(init)
    mix = _salt_mix(tuple(_leaf_shape_key(l) for l in leaves))
    if out is None:
        return digest(leaves, mix)
    return writing_into(digest)(leaves, mix, out=out)


def checksum_device(state: Any, device: DeviceLike = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Digest a batch of states into ``(B, 4)`` int32 lanes, on device.

    Leaves are ``(B, ...)`` tensors, one state per session; row ``b`` equals
    the JAX package's ``checksum_device`` of session ``b``'s state, for any
    number of leaves in any layout.  On the card it is one launch that reads
    every leaf in place where the state has at most ``digest.MAX_LEAVES``
    leaves, each evenly strided with contiguous bytes (any contiguous leaf,
    or a ring slot view ``buf[:, i]``); see ``digest.state_digest`` for the
    rest.  The empty pytree digests to ``_INIT_LANES`` as a ``(1, 4)``
    tensor on ``device`` (the only case that reads ``device``).  Where
    ``out`` is given (a contiguous ``(B, 4)`` int32 tensor) the digests are
    written there, on the card by the kernel itself, and ``out`` is
    returned."""
    return _digest(state, device, state_digest, out)


def checksum_device_plain(state: Any, device: DeviceLike = None) -> torch.Tensor:
    """``checksum_device`` through the plain PyTorch version on any device:
    what the kernel is held against on the card."""
    return _digest(state, device, state_digest_plain)


def lane_sums(words: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The four lane sums of one 1-D int32 word vector, as (4,) int32 --
    the JAX package's ``lane_sums`` in its plain PyTorch form."""
    return lane_sums_rows_plain(words.reshape(1, -1), offset)[0]


def checksum_to_u128(lanes: Any) -> int:
    """Compose a 4-lane digest (int32 bit patterns or uint32) into the u128
    integer the wire/API carries."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.detach().cpu().numpy()
    arr = np.asarray(lanes).astype(np.int64) & MASK32
    if arr.shape != (CHECKSUM_LANES,):
        raise ValueError(f"expected {CHECKSUM_LANES} lanes, got shape {arr.shape}")
    out = 0
    for i, lane in enumerate(arr):
        out |= int(lane) << (32 * i)
    return out


def pytree_checksum(state: Any, device: DeviceLike = None) -> int:
    """One-call convenience for ONE (unbatched) state of tensors: device
    digest + host composition -> u128 int."""
    batched = tree_map(lambda leaf: leaf.unsqueeze(0), state)
    return checksum_to_u128(checksum_device(batched, device)[0])


class DeviceChecksum:
    """A lazily-materialized checksum: holds the ``(4,)`` int32 lane tensor
    on device and converts to the u128 wire integer only when something
    needs the value (``int(cs)`` / ``materialize()``).

    The lanes may be one row of a ``(k, 4)`` digest of several states (the
    executor's burst digests all its saves in one launch): the row is a view,
    so it keeps the whole ``(k, 4)`` result alive until it is read."""

    __slots__ = ("_lanes", "_value")

    def __init__(self, lanes: torch.Tensor) -> None:
        self._lanes: Optional[torch.Tensor] = lanes
        self._value: Optional[int] = None

    def materialize(self) -> int:
        if self._value is None:
            self._value = checksum_to_u128(self._lanes)
            self._lanes = None  # free the device handle
        return self._value

    __int__ = materialize

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, DeviceChecksum):
            other = other.materialize()
        return self.materialize() == other

    def __hash__(self) -> int:
        # materialize() is an int: hash(int) is value-based, unsalted
        return hash(self.materialize())  # ggrs-verify: allow(det/hash-order)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DeviceChecksum({self._value if self._value is not None else '<unread>'})"
