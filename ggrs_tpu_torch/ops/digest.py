"""The state digest's CUDA kernel: its wrappers and their plain versions.

Two entries into one kernel (``csrc/digest.cu``):

- ``state_digest(leaves, salt_mix)`` digests a batch of states straight from
  their leaves: row ``r`` of the ``(R, 4)`` result is the salted digest of
  the words of every leaf's row ``r``, in leaf order.  This is all of
  ``checksum.checksum_device`` in one launch.  Each leaf is ``(R, ...)``
  (or ``(B, n, ...)`` with ``batch_dims=2``, R = B*n) and is read in place
  through a small table -- data pointer, row stride, bytes per row, first
  word index -- passed to the kernel by value, so a ring slot view
  ``buf[:, i]`` is digested without a copy.  At most ``MAX_LEAVES`` leaves.
- ``lane_sums_rows(words, offset)`` digests each row of a ``(R, W)`` word
  matrix to its raw lanes: row ``r`` gets exactly
  ``checksum.lane_sums(words[r], offset)``.  With ``R = 1`` this is the JAX
  package's ``leaf_digest_pallas`` without the tail split.

A leaf's words are its bytes read as little-endian u32, zero-padded to a
4-byte multiple (``as_u32_words``): bitwise the JAX ``_as_u32_words`` for
every dtype.  Words and lanes are ``int32`` tensors holding u32 bit
patterns, as the TPU kernel's output is (``ggrs_tpu/ops/pallas_checksum.py:
57-63``): torch's ``uint32`` has no shifts, sums or ``arange``.

Routing is by the tensor alone: a CPU tensor goes to the plain version, a
CUDA tensor to the kernel (or the call raises).  There is no switch and no
size threshold.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from .. import _build

MASK32 = 0xFFFFFFFF
PRIME_A = 40503
PRIME_B = 2246822519

# the kernel's limits (csrc/digest.cu), checked against the library on load
MAX_LEAVES = 32
GROUP_MAX_WORDS = 1024  # rows up to this many words: one launch, no scratch
SEG_WORDS = 16384  # longer rows: segments of this many words, then a finish pass

# (data pointer, row stride in bytes, bytes per row, first word index)
LeafEntry = Tuple[int, int, int, int]


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bit pattern."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for an int64 tensor ``a`` and an int64 tensor or
    Python int ``b``, both holding values in [0, 2^32).

    ``b`` is split into 16-bit halves so no int64 product overflows (a full
    32x32-bit product would exceed int64's range)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lane_sums_rows_plain(words: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version: int64 arithmetic masked to 32 bits.

    ``words``: (R, W) int32 (u32 bit patterns); returns (R, 4) int32."""
    n = words.shape[1]
    w = words.to(torch.int64) & MASK32
    idx = (torch.arange(1, n + 1, dtype=torch.int64, device=words.device) + offset) & MASK32
    k2 = (idx * PRIME_A + 1) & MASK32
    k3 = mulmod32(idx, PRIME_B)
    # rotl(w, 13): w is non-negative in int64, so >> is a logical shift
    rot = ((w << 13) & MASK32) | (w >> 19)
    lanes = torch.stack(
        [
            w.sum(dim=1),
            mulmod32(w, idx).sum(dim=1),
            mulmod32(w, k2).sum(dim=1),
            (rot ^ k3).sum(dim=1),
        ],
        dim=1,
    )
    return u32_to_i32(lanes & MASK32)


def as_u32_words(x: torch.Tensor) -> torch.Tensor:
    """``(B, ...)`` leaf -> ``(B, n)`` int32 words (u32 bit patterns): per
    row, the leaf's bytes as little-endian u32, zero-padded to a 4-byte
    multiple -- the words the kernel reads in place.  So 4-byte dtypes are
    bitcast, 8-byte dtypes give the low word then the high, 1- and 2-byte
    dtypes pack little-endian, bool is its u8 bytes, and a 0-d u8 leaf is
    one word."""
    b = x.shape[0]
    rows = x.reshape(b, math.prod(x.shape[1:])).contiguous().view(torch.uint8)
    pad = (-rows.shape[1]) % 4
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    return rows.view(torch.int32)


def _row_stride(shape, strides, batch_dims: int):
    """Elements from one row to the next of a tensor of this shape and these
    strides, where its first ``batch_dims`` axes index evenly strided rows
    whose elements are contiguous; None otherwise."""
    expect = 1
    for size, stride in zip(reversed(shape[batch_dims:]), reversed(strides[batch_dims:])):
        if size != 1 and stride != expect:
            return None
        expect *= size
    row, span = None, 1
    for size, stride in zip(reversed(shape[:batch_dims]), reversed(strides[:batch_dims])):
        if size == 1:
            continue
        if row is None:
            row = stride
        elif stride != row * span:
            return None
        span *= size
    return expect if row is None else row


@functools.lru_cache(maxsize=256)
def _layout(batch_dims: int, leaves: tuple) -> Tuple[int, int, tuple]:
    """``(rows, width, entries)`` for leaves given as ``(shape, strides,
    itemsize)``: each entry is ``(leaf index, row stride in bytes, bytes per
    row, first word index)``.  Cached, since a session digests states of one
    layout every frame."""
    if not leaves:
        raise ValueError("state_digest: a state needs at least one leaf")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(
            f"state_digest: {len(leaves)} leaves, the kernel takes at most {MAX_LEAVES}"
        )
    rows = None
    entries = []
    width = 0
    for i, (shape, strides, item) in enumerate(leaves):
        if len(shape) < batch_dims:
            raise ValueError(f"state_digest: leaf of shape {tuple(shape)} has no {batch_dims} batch axes")
        r = math.prod(shape[:batch_dims])
        if rows is None:
            rows = r
        elif r != rows:
            raise ValueError(f"state_digest: leaves hold {rows} and {r} rows")
        stride = _row_stride(shape, strides, batch_dims)
        if stride is None:
            raise ValueError(
                f"state_digest: leaf of shape {tuple(shape)}, strides {strides} is not "
                "evenly strided rows of contiguous bytes"
            )
        nbytes = math.prod(shape[batch_dims:]) * item
        if nbytes:
            entries.append((i, stride * item, nbytes, width))
        width += (nbytes + 3) // 4
    return rows, width, tuple(entries)


def leaf_table(
    leaves: Sequence[torch.Tensor], batch_dims: int = 1
) -> Tuple[List[LeafEntry], int, int]:
    """The kernel's view of a batch of states: ``(entries, rows, width)``.

    One entry ``(data pointer, row stride in bytes, bytes per row, first
    word index)`` per leaf with a non-empty row; ``width`` is the words per
    row over all leaves.  Word ``k`` of a leaf's row ``r`` is bytes
    ``4k..4k+3`` at ``ptr + r * row_stride``, zero past ``row_bytes``, and
    sits at index ``word_off + k`` of row ``r``'s word vector.  Raises where
    the kernel cannot read a leaf in place."""
    rows, width, static = _layout(
        batch_dims, tuple((x.shape, x.stride(), x.element_size()) for x in leaves)
    )
    entries = [(leaves[i].data_ptr(), stride, nbytes, off) for i, stride, nbytes, off in static]
    return entries, rows, width


def state_digest_plain(
    leaves: Sequence[torch.Tensor], salt_mix: Sequence[int], batch_dims: int = 1
) -> torch.Tensor:
    """The plain PyTorch version of ``state_digest``."""
    rows = math.prod(leaves[0].shape[:batch_dims])
    words = [as_u32_words(l.reshape(rows, *l.shape[batch_dims:])) for l in leaves]
    flat = words[0] if len(words) == 1 else torch.cat(words, dim=1)
    lanes = lane_sums_rows_plain(flat).to(torch.int64) & MASK32
    mix = torch.tensor(list(salt_mix), dtype=torch.int64, device=lanes.device)
    acc = (mix + lanes) & MASK32
    return u32_to_i32(acc ^ (acc >> 15))


def _lib() -> ctypes.CDLL:
    lib = _build.load("digest")
    fn = lib.ggrs_state_digest
    if fn.argtypes is None:
        limits = (ctypes.c_longlong * 3)()
        lib.ggrs_digest_limits.argtypes = [ctypes.c_void_p]
        lib.ggrs_digest_limits.restype = None
        lib.ggrs_digest_limits(limits)
        if tuple(limits) != (MAX_LEAVES, GROUP_MAX_WORDS, SEG_WORDS):
            raise RuntimeError(f"digest library limits {tuple(limits)} differ from the wrapper's")
        fn.argtypes = [
            ctypes.c_void_p,  # leaf table: count x 4 int64
            ctypes.c_int,  # count
            ctypes.c_int64,  # rows
            ctypes.c_int64,  # width (words per row)
            ctypes.c_int,  # raw
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,  # mix
            ctypes.c_uint32,  # offset
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # scratch
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def _launch(
    entries: List[LeafEntry], rows: int, width: int, device: torch.device,
    mix: Sequence[int], offset: int, raw: bool,
) -> torch.Tensor:
    """One kernel launch over the table (two where rows span several
    segments); the (rows, 4) int32 result, written whole by the kernel."""
    out = torch.empty((rows, 4), dtype=torch.int32, device=device)
    if rows == 0:
        return out
    segs = -(-width // SEG_WORDS) if width > GROUP_MAX_WORDS else 0
    scratch = torch.empty((rows * segs, 4), dtype=torch.int32, device=device) if segs > 1 else None
    table = (ctypes.c_longlong * (4 * len(entries)))(*[v for e in entries for v in e])
    fn = _lib().ggrs_state_digest
    args = (
        table, len(entries), rows, width, int(raw), *mix, offset & MASK32,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the library launches on the current device
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"digest kernel launch failed: CUDA error {err}")
    return out


def _device_of(tensors: Sequence[torch.Tensor], what: str) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def state_digest(
    leaves: Sequence[torch.Tensor], salt_mix: Sequence[int], batch_dims: int = 1
) -> torch.Tensor:
    """Salted digests ``(R, 4)`` int32 of a batch of states given as their
    leaves; see the module docstring.  ``salt_mix`` is the structure salt
    times 2654435761, four ints in [0, 2^32).

    ``state_digest.launches`` counts the kernel's launches (CPU calls and
    empty batches launch nothing and are not counted)."""
    entries, rows, width = leaf_table(leaves, batch_dims)
    dev = _device_of(leaves, "state_digest")
    if dev.type == "cpu":
        return state_digest_plain(leaves, salt_mix, batch_dims)
    out = _launch(entries, rows, width, dev, salt_mix, 0, raw=False)
    if rows:
        state_digest.launches += 1
    return out


state_digest.launches = 0


def _check(words: torch.Tensor) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"lane_sums_rows: expected a tensor, got {type(words).__name__}")
    if words.dtype != torch.int32:
        raise TypeError(f"lane_sums_rows: words must be int32 (u32 bit patterns), got {words.dtype}")
    if words.dim() != 2:
        raise ValueError(f"lane_sums_rows: words must be 2-D (rows, width), got shape {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("lane_sums_rows: words must be contiguous")


def lane_sums_rows(words: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """(R, W) int32 words -> (R, 4) int32 raw lanes; see the module docstring.

    ``lane_sums_rows.launches`` counts the kernel's launches (CPU calls and
    empty inputs launch nothing and are not counted)."""
    _check(words)
    dev = _device_of([words], "lane_sums_rows")
    if dev.type == "cpu":
        return lane_sums_rows_plain(words, offset)
    entries, rows, width = leaf_table([words])
    out = _launch(entries, rows, width, dev, (0, 0, 0, 0), offset, raw=True)
    if rows:
        lane_sums_rows.launches += 1
    return out


lane_sums_rows.launches = 0
