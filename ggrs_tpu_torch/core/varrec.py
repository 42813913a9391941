"""Variable-size input records in a fixed-size envelope.

The port's own copy of ``ggrs_tpu/core/varrec.py``.  A variable-length byte
record is framed into a fixed ``VARREC_HEADER_BYTES + capacity`` blob as

    [u16 payload_len LE][payload][zero padding to capacity]

so that one record has one envelope (byte equality is value equality) and
the all-zero envelope is the empty record.
"""

from __future__ import annotations

import struct
from typing import Tuple

VARREC_HEADER_FMT = "<H"
VARREC_HEADER_BYTES = 2
VARREC_MAX_CAPACITY = 0xFFFF


def envelope_size(capacity: int) -> int:
    """Fixed encoded size of every varrec input with this capacity."""
    if not 0 < capacity <= VARREC_MAX_CAPACITY:
        raise ValueError(
            f"varrec capacity must be in 1..{VARREC_MAX_CAPACITY}, got {capacity}"
        )
    return VARREC_HEADER_BYTES + capacity


def envelope_pack(payload: bytes, capacity: int) -> bytes:
    """Frame ``payload`` into the fixed-size envelope."""
    n = len(payload)
    if n > capacity:
        raise ValueError(f"varrec payload is {n} bytes but capacity is {capacity}")
    return struct.pack(VARREC_HEADER_FMT, n) + payload + b"\x00" * (capacity - n)


def envelope_split(blob: bytes) -> Tuple[bytes, bytes]:
    """Split an envelope into (payload, padding), padding unchecked."""
    (n,) = struct.unpack_from(VARREC_HEADER_FMT, blob, 0)
    body = blob[VARREC_HEADER_BYTES:]
    if n > len(body):
        raise ValueError(
            f"varrec header claims {n} payload bytes but envelope body is {len(body)}"
        )
    return bytes(body[:n]), bytes(body[n:])


def envelope_unpack(blob: bytes) -> bytes:
    """Extract the payload; rejects non-canonical (nonzero-padded) envelopes."""
    payload, padding = envelope_split(blob)
    if padding.strip(b"\x00"):
        raise ValueError("varrec envelope padding is not all zero")
    return payload
