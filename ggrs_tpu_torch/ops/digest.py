"""Row-batched 4-lane digest: the CUDA kernel's wrapper and its plain version.

``lane_sums_rows(words, offset)`` digests each row of a ``(R, W)`` word
matrix: row ``r`` gets exactly ``checksum.lane_sums(words[r], offset)``.
With ``R = 1`` this is the JAX package's ``leaf_digest_pallas`` without the
tail split; batching over rows is how one launch digests all B sessions.

Words and lanes are ``int32`` tensors holding u32 bit patterns, as the TPU
kernel's output is (``ggrs_tpu/ops/pallas_checksum.py:57-63``): torch's
``uint32`` has no shifts, sums or ``arange``.

Routing is by the tensor alone: a CPU tensor goes to the plain version, a
CUDA tensor to the hand-written kernel in ``csrc/digest.cu`` (or the call
raises).  There is no switch and no size threshold.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

MASK32 = 0xFFFFFFFF
PRIME_A = 40503
PRIME_B = 2246822519


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


def _check(words: torch.Tensor) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"lane_sums_rows: expected a tensor, got {type(words).__name__}")
    if words.dtype != torch.int32:
        raise TypeError(f"lane_sums_rows: words must be int32 (u32 bit patterns), got {words.dtype}")
    if words.dim() != 2:
        raise ValueError(f"lane_sums_rows: words must be 2-D (rows, width), got shape {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("lane_sums_rows: words must be contiguous")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_sums_rows: unsupported device {words.device}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("digest")
    fn = lib.ggrs_lane_sums_rows
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # words
            ctypes.c_void_p,  # out
            ctypes.c_int64,  # rows
            ctypes.c_int64,  # width
            ctypes.c_uint32,  # offset
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def lane_sums_rows(words: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """(R, W) int32 words -> (R, 4) int32 lanes; see the module docstring.

    ``lane_sums_rows.launches`` counts the kernel's launches (CPU calls and
    empty inputs launch nothing and are not counted)."""
    _check(words)
    if words.device.type == "cpu":
        return lane_sums_rows_plain(words, offset)
    rows, width = words.shape
    out = torch.zeros((rows, 4), dtype=torch.int32, device=words.device)
    if rows == 0 or width == 0:
        return out
    fn = _lib().ggrs_lane_sums_rows
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = fn(words.data_ptr(), out.data_ptr(), rows, width, offset & MASK32, stream)
    if err != 0:
        raise RuntimeError(f"digest kernel launch failed: CUDA error {err}")
    lane_sums_rows.launches += 1
    return out


lane_sums_rows.launches = 0
