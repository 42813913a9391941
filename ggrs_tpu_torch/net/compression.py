"""Input compression codec: XOR delta vs the last-acked input, chained
input-to-input, then zero-run-length encoding (the port's copy of
``ggrs_tpu/net/compression.py``: the native dispatch, and the Python codec
``encode_py`` / ``decode_py`` byte for byte).

Same scheme as the reference (GGRS src/network/compression.rs):
each frame's input bytes are XORed against the previous frame's (the first
against the acked reference input), which makes consecutive held-button
inputs mostly zero; the zero runs then collapse under RLE.  Variable-size
inputs are supported by storing chained size deltas (compression.rs:27-53).

Decode is hardened: any malformed or malicious byte string raises
``CodecError`` — never an unhandled exception, never unbounded allocation
(reference hardening: compression.rs:83-182, proptest compression.rs:205-213).

``encode`` and ``decode`` dispatch to the C++ codec (``csrc/host/codec.cpp``
through ``net/_native.py``); the Python implementation is the semantic
reference for both, and takes the packets beyond the native resource caps
(an oversize packet is legal).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import _native
from .wire import Reader, WireError, Writer


class CodecError(Exception):
    """Malformed compressed input data."""


# Never allocate more than this when decoding, regardless of what the packet
# claims (a varint can request a 2^63-byte zero run).
MAX_DECODED_BYTES = 1 << 22


def _xor_prefix(a: bytes, b: bytes, n: int) -> bytes:
    """XOR the first ``n`` bytes of two buffers in one whole-int operation."""
    return (
        int.from_bytes(a[:n], "little") ^ int.from_bytes(b[:n], "little")
    ).to_bytes(n, "little")


def _delta_bytes(reference: bytes, inputs: Sequence[bytes]) -> bytearray:
    """XOR-chain the inputs: input[0] vs reference, input[n] vs input[n-1].
    Bytes beyond the base's length pass through unmodified."""
    out = bytearray()
    base = reference
    for inp in inputs:
        overlap = min(len(base), len(inp))
        out += _xor_prefix(base, inp, overlap)
        out += inp[overlap:]
        base = inp
    return out


def _rle_encode(data: bytes) -> bytes:
    """Zero-run RLE: a stream of tokens ``uvarint header`` where header bit 0
    selects a zero run (length = header >> 1) or a literal run (the next
    header >> 1 bytes are raw)."""
    w = Writer()
    i = 0
    n = len(data)
    while i < n:
        if data[i] == 0:
            j = i
            while j < n and data[j] == 0:
                j += 1
            w.uvarint(((j - i) << 1) | 1)
            i = j
        else:
            # literal run: extend until we meet a zero run of length >= 2
            # (a lone zero is cheaper inlined in the literal than as a token)
            j = i
            while j < n and not (
                data[j] == 0 and (j + 1 == n or data[j + 1] == 0)
            ):
                j += 1
            # a trailing lone zero ends the literal run instead
            w.uvarint((j - i) << 1)
            w.raw(bytes(data[i:j]))
            i = j
    return w.finish()


def _rle_decode(data: bytes, max_bytes: int = MAX_DECODED_BYTES) -> bytearray:
    out = bytearray()
    r = Reader(data)
    try:
        while r.remaining() > 0:
            header = r.uvarint()
            length = header >> 1
            if len(out) + length > max_bytes:
                raise CodecError("decoded data exceeds maximum size")
            if header & 1:
                out.extend(b"\x00" * length)
            else:
                if length > r.remaining():
                    raise CodecError("literal run exceeds remaining data")
                out.extend(r._take(length))
    except WireError as e:
        raise CodecError(str(e)) from e
    return out


def encode(reference: bytes, inputs: Sequence[bytes]) -> bytes:
    """Compress ``inputs`` (oldest first) against ``reference``.

    Dispatches to the C++ codec; the Python implementation below runs when
    the caller switched the native library off."""
    native = _native.encode(reference, inputs)
    if native is not None:
        return native
    return encode_py(reference, inputs)


def decode(reference: bytes, data: bytes) -> List[bytes]:
    """Decompress into the original input byte strings.  Raises CodecError on
    any malformed input.  Dispatches to the C++ codec; packets beyond the
    native resource caps (a None return) take the Python path."""
    native = _native.decode(reference, data)
    if native is not None:
        return native
    return decode_py(reference, data)


def encode_py(reference: bytes, inputs: Sequence[bytes]) -> bytes:
    """Pure-Python encode (the semantic reference)."""
    same_size = len(reference) > 0 and all(len(i) == len(reference) for i in inputs)

    delta = _delta_bytes(reference, inputs)
    rle = _rle_encode(bytes(delta))

    w = Writer()
    if same_size:
        # Common case: receiver infers count from len / len(reference).
        w.u8(0)
    else:
        # Chained size deltas, small under varint when sizes are stable
        # (reference rationale: compression.rs:36-53).
        w.u8(1)
        w.uvarint(len(inputs))
        base = len(reference)
        for inp in inputs:
            w.svarint(len(inp) - base)
            base = len(inp)
    w.bytes(rle)
    return w.finish()


def decode_py(reference: bytes, data: bytes) -> List[bytes]:
    """Pure-Python decode (the semantic reference; hardened: never an
    unhandled exception, never an allocation beyond ``MAX_DECODED_BYTES``)."""
    try:
        r = Reader(data)
        has_sizes = r.u8()
        sizes: Optional[List[int]] = None
        if has_sizes == 1:
            count = r.uvarint()
            if count > MAX_DECODED_BYTES:
                raise CodecError("input count too large")
            sizes = []
            base = len(reference)
            total = 0
            for _ in range(count):
                size = base + r.svarint()
                if size < 0:
                    raise CodecError(f"input size is negative: {size}")
                total += size
                if total > MAX_DECODED_BYTES:
                    raise CodecError("decoded data exceeds maximum size")
                sizes.append(size)
                base = size
        elif has_sizes != 0:
            raise CodecError(f"invalid size-mode byte {has_sizes}")

        rle = r.bytes()
        r.expect_end()
    except WireError as e:
        raise CodecError(str(e)) from e

    delta = _rle_decode(rle)

    if sizes is None:
        if len(reference) == 0:
            raise CodecError(
                "reference must be non-empty to decode inputs of unknown size"
            )
        if len(delta) % len(reference) != 0:
            raise CodecError("encoded bytes not a multiple of the reference size")
        sizes = [len(reference)] * (len(delta) // len(reference))

    if sum(sizes) != len(delta):
        raise CodecError(
            f"decoded byte count {len(delta)} does not match expected sizes "
            f"(sum={sum(sizes)})"
        )

    inputs: List[bytes] = []
    pos = 0
    base = reference
    for size in sizes:
        chunk = bytes(delta[pos : pos + size])
        overlap = min(len(base), size)
        decoded = _xor_prefix(base, chunk, overlap) + chunk[overlap:]
        inputs.append(decoded)
        base = decoded
        pos += size
    return inputs
