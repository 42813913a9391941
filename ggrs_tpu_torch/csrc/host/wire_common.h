// Shared wire-format helpers for the native fast paths (codec.cpp,
// endpoint.cpp).  Header-only; each translation unit gets its own internal
// copies.  Formats are wire.py's: little-endian fixed ints, LEB128 uvarints,
// zigzag svarints — byte-compatible with the Python implementations, which
// remain the reference and the fallback.

#ifndef GGRS_WIRE_COMMON_H_
#define GGRS_WIRE_COMMON_H_

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

// The fast paths memcpy struct.pack('<q')-packed buffers straight into host
// integers (endpoint.cpp emit_input), so a big-endian host would emit wire
// bytes that differ from the Python reference core instead of failing the
// parity contract loudly.  Refuse to build there; _native.py treats a failed
// build as "no native library" and the wire-identical Python cores take over.
#if defined(__BYTE_ORDER__) && defined(__ORDER_LITTLE_ENDIAN__)
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "ggrs native fast paths require a little-endian host; "
              "the Python cores are the big-endian fallback");
#else
#error "cannot determine host endianness; build the Python cores instead"
#endif

namespace ggrs {

constexpr size_t kMaxDecodedBytes = size_t{1} << 22;

// ---- error codes (mirrored in _native.py) --------------------------------
enum ErrorCode : int {
  kOk = 0,
  kErrTruncated = -1,
  kErrVarintTooLong = -2,
  kErrTooLarge = -3,
  kErrLiteralRun = -4,
  kErrBadSizeMode = -5,
  kErrNegativeSize = -6,
  kErrSizeMismatch = -7,
  kErrEmptyReference = -8,
  kErrNotMultiple = -9,
  kErrTrailing = -10,
  kErrBufferTooSmall = -11,
  kErrTooManyInputs = -12,
};

struct Writer {
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void uvarint(uint64_t v) {
    while (true) {
      uint8_t b = v & 0x7F;
      v >>= 7;
      if (v) {
        buf.push_back(b | 0x80);
      } else {
        buf.push_back(b);
        break;
      }
    }
  }
  void svarint(int64_t v) {
    // zigzag, matching wire.py: non-negative -> (v<<1)^(v>>63), negative ->
    // ((-v)<<1)-1 (identical values for 64-bit two's complement)
    uint64_t z = (static_cast<uint64_t>(v) << 1) ^
                 static_cast<uint64_t>(v >> 63);
    uvarint(z);
  }
  void raw(const uint8_t* p, size_t n) { buf.insert(buf.end(), p, p + n); }
};

struct Reader {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;

  size_t remaining() const { return len - pos; }
  int u8(uint8_t* out) {
    if (pos + 1 > len) return kErrTruncated;
    *out = data[pos++];
    return kOk;
  }
  int uvarint(uint64_t* out) {
    int shift = 0;
    uint64_t result = 0;
    while (true) {
      if (shift > 63) return kErrVarintTooLong;
      uint8_t b;
      int rc = u8(&b);
      if (rc != kOk) return rc;
      // at shift 63 only bit 0 fits in u64; Python's unbounded ints keep the
      // high bits and reject the huge value downstream — reject here so both
      // implementations refuse the same packets instead of truncating
      if (shift == 63 && (b & 0x7E)) return kErrTooLarge;
      result |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        *out = result;
        return kOk;
      }
      shift += 7;
    }
  }
  int svarint(int64_t* out) {
    uint64_t v;
    int rc = uvarint(&v);
    if (rc != kOk) return rc;
    *out = static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
    return kOk;
  }
  int take(size_t n, const uint8_t** out) {
    if (pos + n > len || pos + n < pos) return kErrTruncated;
    *out = data + pos;
    pos += n;
    return kOk;
  }
  // uvarint-length-prefixed byte string (Writer.bytes / Reader.bytes)
  int byte_string(const uint8_t** out, size_t* out_len) {
    uint64_t n;
    int rc = uvarint(&n);
    if (rc != kOk) return rc;
    if (n > remaining()) return kErrTruncated;
    *out_len = static_cast<size_t>(n);
    return take(*out_len, out);
  }
};

inline void xor_chain(const uint8_t* base, size_t base_len, const uint8_t* inp,
                      size_t inp_len, std::vector<uint8_t>* out) {
  size_t overlap = base_len < inp_len ? base_len : inp_len;
  size_t start = out->size();
  out->resize(start + inp_len);
  uint8_t* dst = out->data() + start;
  for (size_t i = 0; i < overlap; ++i) dst[i] = base[i] ^ inp[i];
  if (inp_len > overlap) std::memcpy(dst + overlap, inp + overlap, inp_len - overlap);
}

inline void rle_encode(const std::vector<uint8_t>& data, Writer* w) {
  size_t i = 0, n = data.size();
  while (i < n) {
    if (data[i] == 0) {
      size_t j = i;
      while (j < n && data[j] == 0) ++j;
      w->uvarint(((j - i) << 1) | 1);
      i = j;
    } else {
      // literal run: extend until a zero run of length >= 2 begins (a lone
      // zero is cheaper inlined; a trailing lone zero ends the run instead)
      size_t j = i;
      while (j < n && !(data[j] == 0 && (j + 1 == n || data[j + 1] == 0))) ++j;
      w->uvarint((j - i) << 1);
      w->raw(data.data() + i, j - i);
      i = j;
    }
  }
}

inline int rle_decode(const uint8_t* data, size_t len,
                      std::vector<uint8_t>* out) {
  Reader r{data, len};
  while (r.remaining() > 0) {
    uint64_t header;
    int rc = r.uvarint(&header);
    if (rc != kOk) return rc;
    uint64_t run = header >> 1;
    if (out->size() + run > kMaxDecodedBytes) return kErrTooLarge;
    if (header & 1) {
      out->resize(out->size() + run, 0);
    } else {
      if (run > r.remaining()) return kErrLiteralRun;
      const uint8_t* p;
      rc = r.take(static_cast<size_t>(run), &p);
      if (rc != kOk) return rc;
      out->insert(out->end(), p, p + run);
    }
  }
  return kOk;
}

// ---- message framing constants (messages.py tags) ------------------------

enum MsgTag : uint8_t {
  kTagInput = 0,
  kTagInputAck = 1,
  kTagQualityReport = 2,
  kTagQualityReply = 3,
  kTagChecksumReport = 4,
  kTagKeepAlive = 5,
  kTagSyncRequest = 6,
  kTagSyncReply = 7,
};

constexpr size_t kMaxPlayersOnWire = 64;

}  // namespace ggrs

#endif  // GGRS_WIRE_COMMON_H_
