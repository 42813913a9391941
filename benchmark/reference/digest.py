"""The plain reference of the 4-lane state digest, in int64 PyTorch.

A frozen rewrite, kept with the benchmark.  A state's words are its leaves'
int32 elements in sorted key order, read as u32, with 1-based positions i
over the whole state.  Four lanes, each a sum mod 2^32 over the words w:

    w,   w * i,   w * (40503 i + 1),   rotl(w, 13) xor (2246822519 i)

(every product mod 2^32).  A salt mixed from the state's structure (leaf
count, words per leaf, dtype kind and size) is multiplied by 2654435761 and
added to each lane; the digest is ``acc xor (acc >> 15)`` of that sum.
Digests come back as int64 values in [0, 2^32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

MASK = 0xFFFFFFFF
PRIME_A = 40503
PRIME_B = 2246822519
GOLDEN = 2654435761
LANES = 4


def _mulmod(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for values in [0, 2^32), b split in 16-bit halves so
    that no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def structure_salt(shapes: List[Tuple[int, ...]]) -> List[int]:
    """The four salt words of a state of int32 leaves with these
    per-session shapes (in sorted key order)."""
    acc = len(shapes) & MASK
    for shape in shapes:
        acc = (acc * GOLDEN + math.prod(shape)) & MASK
        acc ^= acc >> 15
        acc = (acc * PRIME_B + ord("i") * 256 + 4) & MASK
    out = []
    for i in range(LANES):
        acc = (acc * GOLDEN + i + 1) & MASK
        acc ^= acc >> 13
        out.append(acc)
    return out


def digest(state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(N, 4) int64 digests of N states; every leaf is (N, ...) of 32-bit
    integer values (any integer dtype holding them)."""
    keys = sorted(state)
    n = state[keys[0]].shape[0]
    words = torch.cat([state[k].reshape(n, -1).to(torch.int64) & MASK for k in keys], dim=1)
    idx = torch.arange(1, words.shape[1] + 1, dtype=torch.int64, device=words.device)
    rot = ((words << 13) & MASK) | (words >> 19)
    lanes = torch.stack([
        words.sum(dim=1),
        _mulmod(words, idx).sum(dim=1),
        _mulmod(words, (idx * PRIME_A + 1) & MASK).sum(dim=1),
        (rot ^ _mulmod(idx, PRIME_B)).sum(dim=1),
    ], dim=1) & MASK
    salt = structure_salt([tuple(state[k].shape[1:]) for k in keys])
    mix = torch.tensor([(s * GOLDEN) & MASK for s in salt], dtype=torch.int64, device=words.device)
    acc = (lanes + mix) & MASK
    return acc ^ (acc >> 15)
