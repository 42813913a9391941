// Fused per-endpoint datapath: the per-tick hot path of
// ggrs_tpu_torch/net/protocol.py in one native call each way.
//
// The Python PeerProtocol keeps the reliability *policy* (timers, events,
// state machine, connect-status merging); this module owns the per-tick
// *mechanism* whose Python object churn dominated the live session tick:
//   - the unacked pending-output window and its last-acked compression base
//     (reference: protocol.rs:421-487),
//   - the received-input ring that provides the delta-decode base
//     (reference: protocol.rs:534-682),
//   - building the complete InputMessage datagram (header + statuses +
//     compressed payload) in one pass, byte-identical to messages.py +
//     compression.py,
//   - decoding an incoming InputMessage payload against the ring base and
//     handing back only the NEW frames.
//
// One endpoint object per PeerProtocol; ggrs_tpu_torch/net/endpoint.py wraps this
// ABI and provides the pure-Python fallback core with identical observable
// behavior (tests/test_native_endpoint.py pins wire-level parity).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

#include "wire_common.h"

using namespace ggrs;

namespace {

constexpr int64_t kNullFrame = -1;

// Frames beyond this are malformed (the wire contract is i64 with headroom
// so start_frame±count arithmetic can never overflow); mirrors
// _FRAME_SANE_MIN/MAX in net/endpoint.py.
constexpr int64_t kFrameSaneMin = -(int64_t{1} << 62);
constexpr int64_t kFrameSaneMax = int64_t{1} << 62;

// endpoint-specific return codes (mirrored in _native.py)
constexpr int kEpDrop = -30;      // packet must be dropped (gap / bad base /
                                  // undecodable payload) — matches the Python
                                  // path's silent-drop semantics, no ack
constexpr int kEpFallback = -31;  // legal but exceeds fast-path resources;
                                  // caller retries via the Python codec
constexpr int kEpBadPendingHead = -32;  // pending[0] != last_acked+1 (caller
                                        // raises: protocol invariant broken)

struct FrameBytes {
  int64_t frame;
  std::vector<uint8_t> payload;
};

struct Endpoint {
  // ---- send side ----
  std::deque<FrameBytes> pending;     // unacked outgoing inputs
  std::vector<uint8_t> last_acked;    // delta base for the next send
  int64_t last_acked_frame = kNullFrame;

  // ---- receive side ----
  // ring of recently received frame payloads: the decode base for packet N+1
  // is the payload of start_frame-1.  Ring replaces the Python dict+GC; the
  // explicit cutoff check below reproduces the dict's GC semantics exactly.
  size_t ring_size = 0;
  std::vector<std::vector<uint8_t>> recv_payloads;
  std::vector<int64_t> recv_frames;   // INT64_MIN = empty slot
  std::vector<uint8_t> recv_null_base;  // base before any input arrived
  int64_t last_recv_frame = kNullFrame;
  int64_t max_prediction = 8;

  // scratch for the last on_input decode, awaiting commit()
  std::vector<uint8_t> decoded;       // concatenated new-frame payloads
  std::vector<size_t> decoded_sizes;
  int64_t decoded_first = kNullFrame;

  std::vector<uint8_t> scratch;       // encode scratch

  // ---- observability accumulators (ggrs_ep_stats) ----
  // monotonic counters the stat harvest reads; the datapath never
  // consults them, so they cannot perturb wire behavior
  uint64_t stat_emits = 0;        // input datagrams built (emit_input)
  uint64_t stat_emit_bytes = 0;   // their total wire bytes
  uint64_t stat_acks = 0;         // acks applied (ggrs_ep_ack calls)
  uint64_t stat_datagrams = 0;    // input payloads offered for decode
  uint64_t stat_frames = 0;       // NEW frames staged by decodes
  uint64_t stat_drops = 0;        // kEpDrop outcomes (gap/base/undecodable)
  uint64_t stat_fallbacks = 0;    // kEpFallback outcomes (resource caps)
};

int64_t ring_slot(const Endpoint& ep, int64_t frame) {
  int64_t m = frame % static_cast<int64_t>(ep.ring_size);
  return m < 0 ? m + static_cast<int64_t>(ep.ring_size) : m;
}

// Base payload for delta-decoding a packet that starts at base_frame+1.
// Mirrors _recv_inputs.get(decode_frame) + the GC cutoff
// (protocol.py _on_input): an entry exists iff it was stored and is not
// older than last_recv - 2*max_prediction.
const std::vector<uint8_t>* lookup_base(const Endpoint& ep, int64_t frame) {
  if (frame == kNullFrame) return &ep.recv_null_base;
  if (ep.last_recv_frame != kNullFrame &&
      frame < ep.last_recv_frame - 2 * ep.max_prediction) {
    return nullptr;  // would have been GC'd by the Python dict
  }
  size_t slot = static_cast<size_t>(ring_slot(ep, frame));
  if (ep.recv_frames[slot] != frame) return nullptr;
  return &ep.recv_payloads[slot];
}

void store_recv(Endpoint* ep, int64_t frame, const uint8_t* payload,
                size_t len) {
  size_t slot = static_cast<size_t>(ring_slot(*ep, frame));
  ep->recv_frames[slot] = frame;
  ep->recv_payloads[slot].assign(payload, payload + len);
  if (frame > ep->last_recv_frame) ep->last_recv_frame = frame;
}

}  // namespace

extern "C" {

void* ggrs_ep_new(const uint8_t* send_base, size_t send_base_len,
                  const uint8_t* recv_base, size_t recv_base_len,
                  int64_t max_prediction) {
  Endpoint* ep = new (std::nothrow) Endpoint();
  if (!ep) return nullptr;
  ep->last_acked.assign(send_base, send_base + send_base_len);
  ep->recv_null_base.assign(recv_base, recv_base + recv_base_len);
  ep->max_prediction = max_prediction;
  // ring must outlive the GC window (2*max_prediction) with slack so a slot
  // is never reused while the Python dict would still hold the old entry
  size_t need = static_cast<size_t>(4 * max_prediction + 16);
  ep->ring_size = 64;
  while (ep->ring_size < need) ep->ring_size <<= 1;
  ep->recv_payloads.resize(ep->ring_size);
  ep->recv_frames.assign(ep->ring_size, INT64_MIN);
  return ep;
}

void ggrs_ep_free(void* ptr) { delete static_cast<Endpoint*>(ptr); }

int64_t ggrs_ep_pending_len(void* ptr) {
  return static_cast<int64_t>(static_cast<Endpoint*>(ptr)->pending.size());
}

int64_t ggrs_ep_last_recv_frame(void* ptr) {
  return static_cast<Endpoint*>(ptr)->last_recv_frame;
}

// Pop everything acked through `ack_frame`, keeping the newest popped
// payload as the delta base (protocol.py _pop_pending_output).
void ggrs_ep_ack(void* ptr, int64_t ack_frame) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  ep->stat_acks += 1;
  while (!ep->pending.empty() && ep->pending.front().frame <= ack_frame) {
    ep->last_acked_frame = ep->pending.front().frame;
    ep->last_acked = std::move(ep->pending.front().payload);
    ep->pending.pop_front();
  }
}

// Append this frame's joined per-player payload to the pending window.
// Returns the new pending count (the caller raises the 128-overflow
// disconnect event; the send still happens, as in protocol.py).
int64_t ggrs_ep_push(void* ptr, int64_t frame, const uint8_t* payload,
                     size_t len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  ep->pending.push_back(FrameBytes{frame, {payload, payload + len}});
  return static_cast<int64_t>(ep->pending.size());
}

// Build the complete InputMessage datagram for the current pending window:
// magic + tag + statuses + disconnect_requested + start/ack frames +
// compressed payload.  Byte-identical to InputMessage via messages.py with
// compression.py's codec.  out_len = 0 (rc kOk) when pending is empty (the
// Python path queues nothing).  ack_frame is the endpoint's own
// last_recv_frame, as in protocol.py _send_pending_output.
// status_frames_le: n_status little-endian int64s packed as bytes (the
// Python side builds them with one struct.pack instead of per-element
// ctypes array stores).
int ggrs_ep_emit_input(void* ptr, uint16_t magic,
                       const uint8_t* status_disc,
                       const uint8_t* status_frames_le, int32_t n_status,
                       uint8_t disconnect_requested, uint8_t* out, size_t cap,
                       size_t* out_len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  *out_len = 0;
  if (ep->pending.empty()) return kOk;
  if (n_status < 0 || static_cast<size_t>(n_status) > kMaxPlayersOnWire)
    return kErrTooManyInputs;
  const FrameBytes& first = ep->pending.front();
  if (ep->last_acked_frame != kNullFrame &&
      ep->last_acked_frame + 1 != first.frame) {
    return kEpBadPendingHead;
  }

  // delta+RLE compress the whole pending window against last_acked
  // (compression.py encode): XOR chain, then RLE, then the size-mode header
  std::vector<uint8_t> delta;
  {
    const uint8_t* base = ep->last_acked.data();
    size_t base_len = ep->last_acked.size();
    bool same_size = base_len > 0;
    for (const FrameBytes& fb : ep->pending) {
      if (fb.payload.size() != ep->last_acked.size()) same_size = false;
      xor_chain(base, base_len, fb.payload.data(), fb.payload.size(), &delta);
      base = fb.payload.data();
      base_len = fb.payload.size();
    }
    Writer rle;
    rle_encode(delta, &rle);

    Writer w;
    w.buf.reserve(rle.buf.size() + 64);
    w.u8(static_cast<uint8_t>(magic & 0xFF));
    w.u8(static_cast<uint8_t>(magic >> 8));
    w.u8(kTagInput);
    w.uvarint(static_cast<uint64_t>(n_status));
    for (int32_t i = 0; i < n_status; ++i) {
      w.u8(status_disc[i] ? 1 : 0);
      int64_t f;  // host assumed little-endian (x86-64 / aarch64 hosts)
      std::memcpy(&f, status_frames_le + 8 * i, 8);
      w.svarint(f);
    }
    w.u8(disconnect_requested ? 1 : 0);
    w.svarint(first.frame);                // start_frame
    w.svarint(ep->last_recv_frame);        // ack_frame
    // body payload: the compressed stream with compression.py's envelope
    Writer comp;
    if (same_size) {
      comp.u8(0);
    } else {
      comp.u8(1);
      comp.uvarint(ep->pending.size());
      int64_t base_sz = static_cast<int64_t>(ep->last_acked.size());
      for (const FrameBytes& fb : ep->pending) {
        comp.svarint(static_cast<int64_t>(fb.payload.size()) - base_sz);
        base_sz = static_cast<int64_t>(fb.payload.size());
      }
    }
    comp.uvarint(rle.buf.size());
    comp.raw(rle.buf.data(), rle.buf.size());
    w.uvarint(comp.buf.size());
    w.raw(comp.buf.data(), comp.buf.size());

    if (w.buf.size() > cap) return kErrBufferTooSmall;
    std::memcpy(out, w.buf.data(), w.buf.size());
    *out_len = w.buf.size();
    ep->stat_emits += 1;
    ep->stat_emit_bytes += static_cast<uint64_t>(w.buf.size());
  }
  return kOk;
}

// Decode an incoming InputMessage payload against the ring base.  PEEKS
// ONLY: the new frames are staged in scratch until ggrs_ep_commit() — the
// caller validates the inner per-player framing first so a malformed packet
// is all-or-nothing dropped.  Shared by the two entry points below.
//
// Returns kOk with *out_count new frames (possibly 0: pure-duplicate packet,
// still acked by the caller), kEpDrop when the packet must be silently
// dropped (sequence gap / missing base / undecodable payload), kEpFallback
// when legal-but-huge (caller uses the Python codec via ggrs_ep_fetch_base +
// ggrs_ep_store_one).
static int ep_on_input_inner(Endpoint* ep, int64_t start_frame,
                             const uint8_t* comp, size_t comp_len,
                             uint8_t* out, size_t out_cap, size_t* out_sizes,
                             size_t max_frames, size_t* out_count,
                             int64_t* first_new_frame,
                             int64_t* new_last_recv) {
  *out_count = 0;
  *first_new_frame = kNullFrame;
  *new_last_recv = ep->last_recv_frame;
  ep->decoded.clear();
  ep->decoded_sizes.clear();
  ep->decoded_first = kNullFrame;

  // beyond the i64 wire contract: malformed, drop (also keeps the +1/-1/+i
  // frame arithmetic below clear of signed overflow)
  if (start_frame < kFrameSaneMin || start_frame > kFrameSaneMax) {
    return kEpDrop;
  }
  // unrecoverable gap: impossible from an honest peer, drop
  // (protocol.py _on_input; reference asserts, protocol.rs:588-590)
  if (ep->last_recv_frame != kNullFrame &&
      ep->last_recv_frame + 1 < start_frame) {
    return kEpDrop;
  }
  int64_t base_frame =
      ep->last_recv_frame == kNullFrame ? kNullFrame : start_frame - 1;
  const std::vector<uint8_t>* base = lookup_base(*ep, base_frame);
  if (base == nullptr) return kEpDrop;

  // decompress (compression.py decode semantics, incl. hardening)
  Reader r{comp, comp_len};
  uint8_t has_sizes;
  int rc = r.u8(&has_sizes);
  if (rc != kOk) return kEpDrop;
  std::vector<size_t> sizes;
  bool explicit_sizes = false;
  if (has_sizes == 1) {
    explicit_sizes = true;
    uint64_t count;
    rc = r.uvarint(&count);
    if (rc != kOk) return kEpDrop;
    if (count > kMaxDecodedBytes) return kEpDrop;
    sizes.reserve(static_cast<size_t>(
        count < r.remaining() ? count : r.remaining()));
    int64_t base_sz = static_cast<int64_t>(base->size());
    uint64_t total = 0;
    for (uint64_t i = 0; i < count; ++i) {
      int64_t d;
      rc = r.svarint(&d);
      if (rc != kOk) return kEpDrop;
      int64_t size = static_cast<int64_t>(
          static_cast<uint64_t>(base_sz) + static_cast<uint64_t>(d));
      if (size < 0 || static_cast<uint64_t>(size) > kMaxDecodedBytes)
        return kEpDrop;
      total += static_cast<uint64_t>(size);
      if (total > kMaxDecodedBytes) return kEpDrop;
      sizes.push_back(static_cast<size_t>(size));
      base_sz = size;
    }
  } else if (has_sizes != 0) {
    return kEpDrop;
  }
  const uint8_t* rle;
  size_t rle_len;
  rc = r.byte_string(&rle, &rle_len);
  if (rc != kOk) return kEpDrop;
  if (r.remaining() != 0) return kEpDrop;
  std::vector<uint8_t> delta;
  rc = rle_decode(rle, rle_len, &delta);
  if (rc != kOk) return kEpDrop;
  if (!explicit_sizes) {
    if (base->empty()) return kEpDrop;
    if (delta.size() % base->size() != 0) return kEpDrop;
    sizes.assign(delta.size() / base->size(), base->size());
  }
  uint64_t expect = 0;
  for (size_t s : sizes) expect += s;
  if (expect != delta.size()) return kEpDrop;

  // undo the XOR chain into one contiguous buffer (each frame's payload is
  // the base for the next, exactly as codec.cpp's decode)
  std::vector<uint8_t>& all = ep->scratch;
  all.resize(delta.size());
  {
    const uint8_t* chain_base = base->data();
    size_t chain_base_len = base->size();
    size_t pos = 0;
    for (size_t i = 0; i < sizes.size(); ++i) {
      size_t size = sizes[i];
      uint8_t* dst = all.data() + pos;
      const uint8_t* chunk = delta.data() + pos;
      size_t overlap = chain_base_len < size ? chain_base_len : size;
      for (size_t k = 0; k < overlap; ++k) dst[k] = chain_base[k] ^ chunk[k];
      if (size > overlap)
        std::memcpy(dst + overlap, chunk + overlap, size - overlap);
      chain_base = dst;
      chain_base_len = size;
      pos += size;
    }
  }

  // stage only frames newer than last_recv (duplicates are skipped, as in
  // protocol.py's `frame <= last_recv_frame: continue`)
  {
    size_t pos = 0;
    for (size_t i = 0; i < sizes.size(); ++i) {
      size_t size = sizes[i];
      int64_t frame = start_frame + static_cast<int64_t>(i);
      if (frame > ep->last_recv_frame) {
        if (ep->decoded_sizes.size() >= max_frames ||
            ep->decoded.size() + size > out_cap) {
          ep->decoded.clear();
          ep->decoded_sizes.clear();
          ep->decoded_first = kNullFrame;
          return kEpFallback;
        }
        if (ep->decoded_first == kNullFrame) ep->decoded_first = frame;
        ep->decoded.insert(ep->decoded.end(), all.begin() + pos,
                           all.begin() + pos + size);
        ep->decoded_sizes.push_back(size);
      }
      pos += size;
    }
  }

  std::memcpy(out, ep->decoded.data(), ep->decoded.size());
  for (size_t i = 0; i < ep->decoded_sizes.size(); ++i)
    out_sizes[i] = ep->decoded_sizes[i];
  *out_count = ep->decoded_sizes.size();
  *first_new_frame = ep->decoded_first;
  *new_last_recv = ep->decoded_sizes.empty()
                       ? ep->last_recv_frame
                       : ep->decoded_first +
                             static_cast<int64_t>(ep->decoded_sizes.size()) - 1;
  return kOk;
}

// stats wrapper around the decode: counts outcomes without touching the
// decode's many early-return paths
static int ep_on_input_impl(Endpoint* ep, int64_t start_frame,
                            const uint8_t* comp, size_t comp_len,
                            uint8_t* out, size_t out_cap, size_t* out_sizes,
                            size_t max_frames, size_t* out_count,
                            int64_t* first_new_frame,
                            int64_t* new_last_recv) {
  int rc = ep_on_input_inner(ep, start_frame, comp, comp_len, out, out_cap,
                             out_sizes, max_frames, out_count,
                             first_new_frame, new_last_recv);
  ep->stat_datagrams += 1;
  if (rc == kEpDrop) {
    ep->stat_drops += 1;
  } else if (rc == kEpFallback) {
    ep->stat_fallbacks += 1;
  } else if (rc == kOk) {
    ep->stat_frames += static_cast<uint64_t>(*out_count);
  }
  return rc;
}

int ggrs_ep_on_input(void* ptr, int64_t start_frame, const uint8_t* comp,
                     size_t comp_len, uint8_t* out, size_t out_cap,
                     size_t* out_sizes, size_t max_frames, size_t* out_count,
                     int64_t* first_new_frame, int64_t* new_last_recv) {
  return ep_on_input_impl(static_cast<Endpoint*>(ptr), start_frame, comp,
                          comp_len, out, out_cap, out_sizes, max_frames,
                          out_count, first_new_frame, new_last_recv);
}

// The fused receive: parse a complete InputMessage datagram, apply its ack,
// and stage its new frames — ONE crossing for the per-tick hot packet.
// Header fields come back through the scalar/array outs so the Python side
// can run the connect-status merge and inner-framing validation before
// ggrs_ep_commit().
//
// Returns: kOk (frames staged), kEpDrop (header parsed + ack applied, but
// the payload must be dropped: gap / missing base / undecodable), kEpFallback
// (ack applied; caller retries via the object path), or a message-framing
// error (nothing applied — the caller drops the datagram exactly as the
// socket layer drops undecodable packets).
int ggrs_ep_handle_input_datagram(
    void* ptr, const uint8_t* data, size_t len, uint16_t* magic,
    uint8_t* disconnect_requested, uint8_t* status_disc,
    int64_t* status_frames, int32_t* n_status, int64_t* start_frame,
    uint8_t* out, size_t out_cap, size_t* out_sizes, size_t max_frames,
    size_t* out_count, int64_t* first_new_frame, int64_t* new_last_recv) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  Reader r{data, len};
  const uint8_t* p;
  int rc = r.take(2, &p);
  if (rc != kOk) return rc;
  *magic = static_cast<uint16_t>(p[0] | (p[1] << 8));
  uint8_t tag;
  rc = r.u8(&tag);
  if (rc != kOk) return rc;
  if (tag != kTagInput) return kEpFallback;  // caller routes by tag; guard

  uint64_t n;
  rc = r.uvarint(&n);
  if (rc == kOk && n > kMaxPlayersOnWire) return kErrTooManyInputs;
  for (uint64_t i = 0; rc == kOk && i < n; ++i) {
    uint8_t b;
    rc = r.u8(&b);
    if (rc != kOk) break;
    if (b > 1) return kErrBadSizeMode;  // bad bool byte: malformed
    status_disc[i] = b;
    rc = r.svarint(&status_frames[i]);
  }
  if (rc == kOk) {
    uint8_t b = 0;
    rc = r.u8(&b);
    if (rc == kOk) {
      if (b > 1) return kErrBadSizeMode;
      *disconnect_requested = b;
    }
  }
  int64_t ack_frame = 0;
  if (rc == kOk) rc = r.svarint(start_frame);
  if (rc == kOk) rc = r.svarint(&ack_frame);
  const uint8_t* payload = nullptr;
  size_t payload_len = 0;
  if (rc == kOk) rc = r.byte_string(&payload, &payload_len);
  // a varint beyond u64 decodes fine under Python's unbounded ints: hand the
  // datagram to the object path for bit-identical behavior
  if (rc == kErrTooLarge) return kEpFallback;
  if (rc != kOk) return rc;
  if (r.remaining() != 0) return kErrTrailing;
  *n_status = static_cast<int32_t>(n);

  // header fully parsed: apply the ack (protocol.py _on_input order), then
  // decode + stage
  ggrs_ep_ack(ptr, ack_frame);
  return ep_on_input_impl(ep, *start_frame, payload, payload_len, out,
                          out_cap, out_sizes, max_frames, out_count,
                          first_new_frame, new_last_recv);
}

// Commit the frames staged by the last ggrs_ep_on_input: store them in the
// recv ring and advance last_recv_frame.  Call after inner-framing
// validation succeeds; skip to drop the packet with no state change.
void ggrs_ep_commit(void* ptr) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  const uint8_t* p = ep->decoded.data();
  for (size_t i = 0; i < ep->decoded_sizes.size(); ++i) {
    store_recv(ep, ep->decoded_first + static_cast<int64_t>(i), p,
               ep->decoded_sizes[i]);
    p += ep->decoded_sizes[i];
  }
  ep->decoded.clear();
  ep->decoded_sizes.clear();
  ep->decoded_first = kNullFrame;
}

// ---- escape hatches for the Python-codec fallback path -------------------

// Fetch the decode base for a packet starting at `start_frame` (the payload
// of start_frame-1, or the null base).  rc kEpDrop when unavailable.
int ggrs_ep_fetch_base(void* ptr, int64_t start_frame, uint8_t* out,
                       size_t cap, size_t* out_len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  int64_t base_frame =
      ep->last_recv_frame == kNullFrame ? kNullFrame : start_frame - 1;
  const std::vector<uint8_t>* base = lookup_base(*ep, base_frame);
  if (base == nullptr) return kEpDrop;
  if (base->size() > cap) return kErrBufferTooSmall;
  std::memcpy(out, base->data(), base->size());
  *out_len = base->size();
  return kOk;
}

// Store one received frame payload directly (Python-codec fallback commit).
void ggrs_ep_store_one(void* ptr, int64_t frame, const uint8_t* payload,
                       size_t len) {
  store_recv(static_cast<Endpoint*>(ptr), frame, payload, len);
}

// ---- eviction / supervision support --------------------------------------
//
// The supervised session bank (session_bank.cpp) evicts a faulted slot to
// the per-session Python path, resuming from the slot's last committed
// state.  The dump APIs let the bank's harvest read an endpoint's resumable
// datapath state; the seed API lets a freshly-built core adopt the send side
// (the receive side seeds through the existing ggrs_ep_store_one).  Framing
// is fixed little-endian: [i64 frame][u32 len][bytes] per entry.

namespace {

void dump_i64(uint8_t* out, size_t* pos, int64_t v) {
  std::memcpy(out + *pos, &v, 8);  // little-endian host (wire_common.h)
  *pos += 8;
}

void dump_u32(uint8_t* out, size_t* pos, uint32_t v) {
  std::memcpy(out + *pos, &v, 4);
  *pos += 4;
}

void dump_u16(uint8_t* out, size_t* pos, uint16_t v) {
  std::memcpy(out + *pos, &v, 2);
  *pos += 2;
}

}  // namespace

// Send-side dump:
//   [i64 last_acked_frame][u32 base_len][base bytes]
//   [u16 n_pending] then per entry [i64 frame][u32 len][bytes]
// Returns kOk, or kErrBufferTooSmall with *out_len = needed size.
int ggrs_ep_dump_send(void* ptr, uint8_t* out, size_t cap, size_t* out_len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  size_t need = 8 + 4 + ep->last_acked.size() + 2;
  for (const FrameBytes& fb : ep->pending) need += 12 + fb.payload.size();
  *out_len = need;
  if (need > cap) return kErrBufferTooSmall;
  size_t pos = 0;
  dump_i64(out, &pos, ep->last_acked_frame);
  dump_u32(out, &pos, static_cast<uint32_t>(ep->last_acked.size()));
  std::memcpy(out + pos, ep->last_acked.data(), ep->last_acked.size());
  pos += ep->last_acked.size();
  dump_u16(out, &pos, static_cast<uint16_t>(ep->pending.size()));
  for (const FrameBytes& fb : ep->pending) {
    dump_i64(out, &pos, fb.frame);
    dump_u32(out, &pos, static_cast<uint32_t>(fb.payload.size()));
    std::memcpy(out + pos, fb.payload.data(), fb.payload.size());
    pos += fb.payload.size();
  }
  return kOk;
}

// Receive-side dump: every ring entry still inside the GC window (these are
// the delta-decode bases a resumed core needs so in-flight packets keep
// decoding): [i64 last_recv_frame][u16 n] then per entry
// [i64 frame][u32 len][bytes].  Entry order is ascending frame.
int ggrs_ep_dump_recv(void* ptr, uint8_t* out, size_t cap, size_t* out_len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  int64_t lo = ep->last_recv_frame == kNullFrame
                   ? 0
                   : ep->last_recv_frame - 2 * ep->max_prediction;
  if (lo < 0) lo = 0;  // frames on the ring are >= 0; NULL is the null base
  size_t need = 8 + 2;
  uint16_t n = 0;
  for (int64_t f = lo; f <= ep->last_recv_frame; ++f) {
    const std::vector<uint8_t>* p = lookup_base(*ep, f);
    if (p != nullptr) {
      need += 12 + p->size();
      ++n;
    }
  }
  *out_len = need;
  if (need > cap) return kErrBufferTooSmall;
  size_t pos = 0;
  dump_i64(out, &pos, ep->last_recv_frame);
  dump_u16(out, &pos, n);
  for (int64_t f = lo; f <= ep->last_recv_frame; ++f) {
    const std::vector<uint8_t>* p = lookup_base(*ep, f);
    if (p == nullptr) continue;
    dump_i64(out, &pos, f);
    dump_u32(out, &pos, static_cast<uint32_t>(p->size()));
    std::memcpy(out + pos, p->data(), p->size());
    pos += p->size();
  }
  return kOk;
}

// Adopt the send-side delta base: the resumed pending window (re-fed via
// ggrs_ep_push) compresses against — and must sequentially follow — the
// exact base the peer last acked.
void ggrs_ep_seed_send(void* ptr, int64_t last_acked_frame,
                       const uint8_t* base, size_t len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  ep->last_acked_frame = last_acked_frame;
  ep->last_acked.assign(base, base + len);
}

// Rewind the send window to an earlier delta base (the fleet failover
// seam): a peer that resumed from its durable journal may genuinely hold
// LESS than it once acked, and its repeated regressive acks ask us to
// rebase.  Drops the whole pending window (the caller re-pushes the
// frames after `frame` from its sent-payload ring) and reseeds the base,
// exactly like seed_send on a fresh endpoint.
void ggrs_ep_rewind_send(void* ptr, int64_t frame, const uint8_t* base,
                         size_t len) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  ep->pending.clear();
  ep->last_acked_frame = frame;
  ep->last_acked.assign(base, base + len);
}

// ---- observability (the obs stat harvest) --------------------------------

int64_t ggrs_ep_last_acked_frame(void* ptr) {
  return static_cast<Endpoint*>(ptr)->last_acked_frame;
}

// Read the core's monotonic observability counters in one call.
// out7 layout: emits, emit_bytes, acks, datagrams, new_frames, drops,
// fallbacks (all u64; mirrored in ggrs_tpu_torch/net/_native.py EP_STAT_FIELDS
// and read per endpoint by ggrs_bank_stats).
void ggrs_ep_stats(void* ptr, uint64_t* out7) {
  Endpoint* ep = static_cast<Endpoint*>(ptr);
  out7[0] = ep->stat_emits;
  out7[1] = ep->stat_emit_bytes;
  out7[2] = ep->stat_acks;
  out7[3] = ep->stat_datagrams;
  out7[4] = ep->stat_frames;
  out7[5] = ep->stat_drops;
  out7[6] = ep->stat_fallbacks;
}

}  // extern "C"
