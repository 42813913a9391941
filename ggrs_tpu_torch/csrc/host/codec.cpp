// Native input codec: XOR-delta + zero-run RLE, byte-compatible with
// ggrs_tpu_torch/net/compression.py (same scheme as the reference's
// network/compression.rs: delta vs last-acked input, chained input-to-input,
// then run-length encoding; hardened decode that errors — never crashes or
// over-allocates — on malicious bytes).
//
// This is the one host-side component hot enough to warrant hand-written
// C++ (SURVEY §2 native-component note): it runs per-packet on the UDP path
// for every peer.  Exposed through a minimal C ABI consumed via ctypes
// (ggrs_tpu_torch/net/_native.py); no pybind11 dependency.  Shared wire-format
// helpers live in wire_common.h (also used by endpoint.cpp, the fused
// per-endpoint datapath).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#include "wire_common.h"

using namespace ggrs;

extern "C" {

// Upper bound on the encoded size for a given total payload.
size_t ggrs_codec_encode_bound(size_t total_input_bytes, size_t n_inputs) {
  // mode byte + count varint + per-input size varints + rle worst case
  // (every byte literal: ~2 bytes/byte of header amortized, bounded by
  // total + 10 bytes per token) + length prefix
  return 1 + 10 + n_inputs * 10 + total_input_bytes * 2 + 20;
}

// Compress `n_inputs` byte strings (concatenated in `inputs`, lengths in
// `input_lens`) against `reference`.  Returns kOk and writes `*out_len`.
int ggrs_codec_encode(const uint8_t* reference, size_t reference_len,
                      const uint8_t* inputs, const size_t* input_lens,
                      size_t n_inputs, uint8_t* out, size_t out_cap,
                      size_t* out_len) {
  bool same_size = reference_len > 0;
  for (size_t i = 0; i < n_inputs && same_size; ++i) {
    if (input_lens[i] != reference_len) same_size = false;
  }

  std::vector<uint8_t> delta;
  {
    const uint8_t* base = reference;
    size_t base_len = reference_len;
    const uint8_t* p = inputs;
    for (size_t i = 0; i < n_inputs; ++i) {
      xor_chain(base, base_len, p, input_lens[i], &delta);
      base = p;
      base_len = input_lens[i];
      p += input_lens[i];
    }
  }

  Writer rle;
  rle_encode(delta, &rle);

  Writer w;
  if (same_size) {
    w.u8(0);
  } else {
    w.u8(1);
    w.uvarint(n_inputs);
    int64_t base = static_cast<int64_t>(reference_len);
    for (size_t i = 0; i < n_inputs; ++i) {
      w.svarint(static_cast<int64_t>(input_lens[i]) - base);
      base = static_cast<int64_t>(input_lens[i]);
    }
  }
  w.uvarint(rle.buf.size());
  w.raw(rle.buf.data(), rle.buf.size());

  if (w.buf.size() > out_cap) return kErrBufferTooSmall;
  std::memcpy(out, w.buf.data(), w.buf.size());
  *out_len = w.buf.size();
  return kOk;
}

// Decompress `data` against `reference`.  Decoded payload is written to
// `out` (cap `out_cap`); per-input sizes to `out_sizes` (cap `max_inputs`);
// `*out_count` receives the number of inputs.  All hardening mirrors the
// Python decoder: malicious bytes produce an error code, never UB or
// unbounded allocation.
int ggrs_codec_decode(const uint8_t* reference, size_t reference_len,
                      const uint8_t* data, size_t data_len, uint8_t* out,
                      size_t out_cap, size_t* out_sizes, size_t max_inputs,
                      size_t* out_count) {
  Reader r{data, data_len};
  uint8_t has_sizes;
  int rc = r.u8(&has_sizes);
  if (rc != kOk) return rc;

  std::vector<size_t> sizes;
  bool explicit_sizes = false;
  if (has_sizes == 1) {
    explicit_sizes = true;
    uint64_t count;
    rc = r.uvarint(&count);
    if (rc != kOk) return rc;
    if (count > kMaxDecodedBytes) return kErrTooLarge;
    // each size delta costs at least one byte, so never reserve more slots
    // than the packet could possibly back (memory-amplification hardening)
    sizes.reserve(static_cast<size_t>(
        count < r.remaining() ? count : r.remaining()));
    int64_t base = static_cast<int64_t>(reference_len);
    uint64_t total = 0;
    for (uint64_t i = 0; i < count; ++i) {
      int64_t d;
      rc = r.svarint(&d);
      if (rc != kOk) return rc;
      // unsigned add: defined on overflow, and any wrapped value is caught
      // by the negative/too-large checks below (base is always in
      // [0, kMaxDecodedBytes], so valid sizes can never wrap)
      int64_t size = static_cast<int64_t>(
          static_cast<uint64_t>(base) + static_cast<uint64_t>(d));
      if (size < 0 || static_cast<uint64_t>(size) > kMaxDecodedBytes)
        return kErrNegativeSize;
      total += static_cast<uint64_t>(size);
      if (total > kMaxDecodedBytes) return kErrTooLarge;
      sizes.push_back(static_cast<size_t>(size));
      base = size;
    }
  } else if (has_sizes != 0) {
    return kErrBadSizeMode;
  }

  const uint8_t* rle;
  size_t rle_len;
  rc = r.byte_string(&rle, &rle_len);
  if (rc != kOk) return rc;
  if (r.remaining() != 0) return kErrTrailing;

  std::vector<uint8_t> delta;
  rc = rle_decode(rle, rle_len, &delta);
  if (rc != kOk) return rc;

  if (!explicit_sizes) {
    if (reference_len == 0) return kErrEmptyReference;
    if (delta.size() % reference_len != 0) return kErrNotMultiple;
    sizes.assign(delta.size() / reference_len, reference_len);
  }

  uint64_t expect = 0;
  for (size_t s : sizes) expect += s;
  if (expect != delta.size()) return kErrSizeMismatch;
  if (sizes.size() > max_inputs) return kErrTooManyInputs;
  if (delta.size() > out_cap) return kErrBufferTooSmall;

  // undo the XOR chain in place into `out`
  const uint8_t* base = reference;
  size_t base_len = reference_len;
  size_t pos = 0;
  for (size_t i = 0; i < sizes.size(); ++i) {
    size_t size = sizes[i];
    uint8_t* dst = out + pos;
    const uint8_t* chunk = delta.data() + pos;
    size_t overlap = base_len < size ? base_len : size;
    for (size_t k = 0; k < overlap; ++k) dst[k] = base[k] ^ chunk[k];
    if (size > overlap) std::memcpy(dst + overlap, chunk + overlap, size - overlap);
    out_sizes[i] = size;
    base = dst;
    base_len = size;
    pos += size;
  }
  *out_count = sizes.size();
  return kOk;
}

}  // extern "C"

// ===========================================================================
// Message framing fast path (ggrs_tpu_torch/net/messages.py + wire.py)
// ===========================================================================
//
// The per-packet envelope — magic, tag, body fields, varints — is the other
// host-side hot path: every peer parses every datagram through it.  The
// format is wire.py's (little-endian fixed ints + LEB128 uvarints + zigzag
// svarints); these functions are byte-compatible with messages.py's
// encode/decode and are property-tested against them
// (tests/test_native_codec.py).  Values a u64 cannot hold (Python's ints are
// unbounded) return kMsgFallback so the caller can use the Python decoder —
// identical observable behavior, just slower, on absurd-but-legal packets.

namespace {

constexpr int kMsgFallback = -100;
constexpr int kMsgBadBool = -20;
constexpr int kMsgUnknownTag = -21;
constexpr int kMsgTooManyStatuses = -22;
constexpr int kMsgTrailing = -23;

}  // namespace

extern "C" {

// Fixed-size decode target, caller-allocated and reused across packets.
// payload_off/len index into the SOURCE buffer (zero-copy for input bytes).
struct GgrsMsg {
  uint16_t magic;
  uint8_t tag;
  uint8_t disconnect_requested;
  int64_t start_frame;
  int64_t ack_frame;
  int64_t frame;
  int16_t frame_advantage;
  uint64_t ping;
  uint64_t pong;
  uint64_t checksum_lo;
  uint64_t checksum_hi;
  uint64_t random_nonce;
  int32_t n_status;
  uint64_t payload_off;
  uint64_t payload_len;
  uint8_t status_disconnected[kMaxPlayersOnWire];
  int64_t status_last_frame[kMaxPlayersOnWire];
};

int ggrs_msg_decode(const uint8_t* buf, size_t len, GgrsMsg* out) {
  Reader r{buf, len};
  const uint8_t* p;
  int rc = r.take(2, &p);
  if (rc != kOk) return rc;
  out->magic = static_cast<uint16_t>(p[0] | (p[1] << 8));
  rc = r.u8(&out->tag);
  if (rc != kOk) return rc;

  auto read_bool = [&](uint8_t* v) -> int {
    uint8_t b;
    int rc2 = r.u8(&b);
    if (rc2 != kOk) return rc2;
    if (b > 1) return kMsgBadBool;
    *v = b;
    return kOk;
  };

  switch (out->tag) {
    case kTagInput: {
      uint64_t n;
      rc = r.uvarint(&n);
      if (rc != kOk) break;
      if (n > kMaxPlayersOnWire) return kMsgTooManyStatuses;
      out->n_status = static_cast<int32_t>(n);
      for (uint64_t i = 0; i < n; ++i) {
        rc = read_bool(&out->status_disconnected[i]);
        if (rc != kOk) break;
        rc = r.svarint(&out->status_last_frame[i]);
        if (rc != kOk) break;
      }
      if (rc != kOk) break;
      rc = read_bool(&out->disconnect_requested);
      if (rc != kOk) break;
      rc = r.svarint(&out->start_frame);
      if (rc != kOk) break;
      rc = r.svarint(&out->ack_frame);
      if (rc != kOk) break;
      const uint8_t* payload;
      size_t payload_len;
      rc = r.byte_string(&payload, &payload_len);
      if (rc != kOk) break;
      out->payload_off = static_cast<uint64_t>(payload - buf);
      out->payload_len = payload_len;
      break;
    }
    case kTagInputAck:
      rc = r.svarint(&out->ack_frame);
      break;
    case kTagQualityReport: {
      rc = r.take(2, &p);
      if (rc != kOk) break;
      out->frame_advantage =
          static_cast<int16_t>(p[0] | (static_cast<uint16_t>(p[1]) << 8));
      rc = r.take(8, &p);
      if (rc != kOk) break;
      std::memcpy(&out->ping, p, 8);
      break;
    }
    case kTagQualityReply:
      rc = r.take(8, &p);
      if (rc != kOk) break;
      std::memcpy(&out->pong, p, 8);
      break;
    case kTagChecksumReport:
      rc = r.svarint(&out->frame);
      if (rc != kOk) break;
      rc = r.take(16, &p);
      if (rc != kOk) break;
      std::memcpy(&out->checksum_lo, p, 8);
      std::memcpy(&out->checksum_hi, p + 8, 8);
      break;
    case kTagKeepAlive:
      break;
    case kTagSyncRequest:
      rc = r.uvarint(&out->random_nonce);
      break;
    case kTagSyncReply:
      rc = r.uvarint(&out->random_nonce);
      break;
    default:
      return kMsgUnknownTag;
  }
  // a varint whose value needs > 64 bits decodes fine in Python (unbounded
  // ints) — hand those packets back to the Python decoder for bit-identical
  // observable behavior
  if (rc == kErrTooLarge) return kMsgFallback;
  if (rc != kOk) return rc;
  if (r.remaining() != 0) return kMsgTrailing;
  return kOk;
}

int ggrs_msg_encode(const GgrsMsg* m, const uint8_t* payload,
                    size_t payload_len, uint8_t* out, size_t cap,
                    size_t* out_len) {
  Writer w;
  w.buf.reserve(64 + payload_len);
  w.u8(static_cast<uint8_t>(m->magic & 0xFF));
  w.u8(static_cast<uint8_t>(m->magic >> 8));
  w.u8(m->tag);
  switch (m->tag) {
    case kTagInput: {
      if (m->n_status < 0 ||
          static_cast<size_t>(m->n_status) > kMaxPlayersOnWire) {
        return kMsgTooManyStatuses;
      }
      w.uvarint(static_cast<uint64_t>(m->n_status));
      for (int32_t i = 0; i < m->n_status; ++i) {
        w.u8(m->status_disconnected[i] ? 1 : 0);
        w.svarint(m->status_last_frame[i]);
      }
      w.u8(m->disconnect_requested ? 1 : 0);
      w.svarint(m->start_frame);
      w.svarint(m->ack_frame);
      w.uvarint(payload_len);
      w.raw(payload, payload_len);
      break;
    }
    case kTagInputAck:
      w.svarint(m->ack_frame);
      break;
    case kTagQualityReport: {
      uint16_t adv = static_cast<uint16_t>(m->frame_advantage);
      w.u8(static_cast<uint8_t>(adv & 0xFF));
      w.u8(static_cast<uint8_t>(adv >> 8));
      for (int i = 0; i < 8; ++i)
        w.u8(static_cast<uint8_t>(m->ping >> (8 * i)));
      break;
    }
    case kTagQualityReply:
      for (int i = 0; i < 8; ++i)
        w.u8(static_cast<uint8_t>(m->pong >> (8 * i)));
      break;
    case kTagChecksumReport:
      w.svarint(m->frame);
      for (int i = 0; i < 8; ++i)
        w.u8(static_cast<uint8_t>(m->checksum_lo >> (8 * i)));
      for (int i = 0; i < 8; ++i)
        w.u8(static_cast<uint8_t>(m->checksum_hi >> (8 * i)));
      break;
    case kTagKeepAlive:
      break;
    case kTagSyncRequest:
    case kTagSyncReply:
      w.uvarint(m->random_nonce);
      break;
    default:
      return kMsgUnknownTag;
  }
  if (w.buf.size() > cap) return kErrBufferTooSmall;
  std::memcpy(out, w.buf.data(), w.buf.size());
  *out_len = w.buf.size();
  return kOk;
}

}  // extern "C"
