"""Compact binary wire encoding used for all messages (the port's copy of
``ggrs_tpu/net/wire.py``: the two packages' peers speak the same bytes).

The reference serializes messages with bincode (fixed-width little-endian
integers, u64 length prefixes — GGRS src/network/udp_socket.rs:38).
We define our own framing with the same flavor but varint length prefixes to
stay under the ~508-byte ideal UDP packet budget (udp_socket.rs:14).

Decoding is hardened: every reader raises ``WireError`` (never an unhandled
exception) on truncated or malformed data, because packets can come from
malicious peers (reference hardening: network/compression.rs:83-182).
"""

from __future__ import annotations

import struct
from typing import List, Tuple


class WireError(Exception):
    """Malformed or truncated wire data."""


def encode_uvarint(v: int) -> bytes:
    """One unsigned varint as bytes: the single definition behind
    ``Writer.uvarint``."""
    if v < 0:
        raise ValueError("uvarint requires non-negative value")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    return bytes(out)


class Writer:
    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def u8(self, v: int) -> "Writer":
        self._parts.append(struct.pack("<B", v & 0xFF))
        return self

    def u16(self, v: int) -> "Writer":
        self._parts.append(struct.pack("<H", v & 0xFFFF))
        return self

    def i16(self, v: int) -> "Writer":
        self._parts.append(struct.pack("<h", v))
        return self

    def i32(self, v: int) -> "Writer":
        self._parts.append(struct.pack("<i", v))
        return self

    def u64(self, v: int) -> "Writer":
        self._parts.append(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))
        return self

    def u128(self, v: int) -> "Writer":
        self._parts.append(
            struct.pack("<QQ", v & 0xFFFFFFFFFFFFFFFF, (v >> 64) & 0xFFFFFFFFFFFFFFFF)
        )
        return self

    def bool(self, v: bool) -> "Writer":
        return self.u8(1 if v else 0)

    def uvarint(self, v: int) -> "Writer":
        self._parts.append(encode_uvarint(v))
        return self

    def svarint(self, v: int) -> "Writer":
        # zigzag
        return self.uvarint((v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1)

    def bytes(self, b: bytes) -> "Writer":
        self.uvarint(len(b))
        self._parts.append(b)
        return self

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def finish(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise WireError("truncated data")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def i16(self) -> int:
        return struct.unpack("<h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def u128(self) -> int:
        lo, hi = struct.unpack("<QQ", self._take(16))
        return lo | (hi << 64)

    def bool(self) -> bool:
        v = self.u8()
        if v not in (0, 1):
            raise WireError(f"invalid bool byte {v}")
        return v == 1

    def uvarint(self) -> int:
        shift = 0
        result = 0
        while True:
            if shift > 63:
                raise WireError("uvarint too long")
            b = self.u8()
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                return result
            shift += 7

    def svarint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def bytes(self) -> bytes:
        n = self.uvarint()
        if n > len(self._data) - self._pos:
            raise WireError("byte string length exceeds remaining data")
        return self._take(n)

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def expect_end(self) -> None:
        if self.remaining() != 0:
            raise WireError("trailing bytes after message")
