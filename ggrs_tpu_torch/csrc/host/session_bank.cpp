// Native host-loop session bank: step EVERY pooled session's protocol +
// sync mechanism in ONE ctypes crossing per pool tick.
//
// The per-operation mechanisms are native (sync_core.cpp, endpoint.cpp), and
// alone they measured perf-neutral: ~200 ctypes crossings per session-tick
// hand back the ~13% the C++ saves (docs/ROUND5.md §4).
// This module composes those SAME mechanisms — it calls their extern "C"
// APIs, it does not reimplement them — into a bank of B sessions, and
// ggrs_bank_tick() walks all of them off one packed command buffer:
//
//   per session: [ctrl ops] [inbound datagrams] [local input bytes]
//     -> poll:    route datagrams (ack trim, delta-decode, ring commit,
//                 remote-input enqueue), frame-advantage update, timers
//                 (retry / quality / keep-alive / disconnect detector)
//     -> advance: confirmed-frame watermark, consistency check + rollback
//                 resim descriptor, local-input enqueue, outbound
//                 InputMessage assembly, synchronized-input assembly
//   per session: [request ops] [outbound datagrams] [events] [status mirrors]
//
// POLICY STAYS IN PYTHON (ggrs_tpu_torch/parallel/host_bank.py): GgrsEvent
// emission, the disconnect consensus, wait-recommendation pacing, and
// GgrsRequest construction all happen above the seam, driven by the event
// records and status mirrors this file returns.  The per-session Python
// path (sessions/p2p.py over net/protocol.py) is the untouched semantic
// reference; tests/test_session_bank.py pins the bank bit-identical to it
// (wire bytes, frames, events) under seeded loss/dup/reorder traffic.
//
// Known, documented divergences (all unreachable from honest bank peers,
// all covered exactly by the Python fallback path):
//  - datagrams needing Python's unbounded-int decode (varints beyond u64)
//    or exceeding the receive staging caps are dropped, not re-decoded;
//  - disconnect consensus and EvDisconnected reactions apply one pool tick
//    late (Python turns this tick's events into next tick's ctrl ops).
//
// FAULT ISOLATION: a per-session mechanism error no longer fails the
// tick.  Each session's output record leads with an i32 err code; a faulted
// slot's ops/outbound/events are suppressed for that tick while the other
// B-1 sessions step normally.  host_bank.py quarantines the slot, harvests
// its last committed state (ggrs_bank_harvest), and evicts it to the
// untouched per-session Python path or marks it dead.  The only remaining
// whole-bank failure is a malformed command stream (kBankErrCmd), which can
// only mean the Python command builder itself is broken.

#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <new>
#include <vector>

#include "wire_common.h"

using namespace ggrs;

// ---- the composed mechanisms (sync_core.cpp / endpoint.cpp, same .so) ----
extern "C" {
void* ggrs_ep_new(const uint8_t*, size_t, const uint8_t*, size_t, int64_t);
void ggrs_ep_free(void*);
int64_t ggrs_ep_pending_len(void*);
int64_t ggrs_ep_last_recv_frame(void*);
void ggrs_ep_ack(void*, int64_t);
int64_t ggrs_ep_push(void*, int64_t, const uint8_t*, size_t);
int ggrs_ep_emit_input(void*, uint16_t, const uint8_t*, const uint8_t*,
                       int32_t, uint8_t, uint8_t*, size_t, size_t*);
int ggrs_ep_handle_input_datagram(void*, const uint8_t*, size_t, uint16_t*,
                                  uint8_t*, uint8_t*, int64_t*, int32_t*,
                                  int64_t*, uint8_t*, size_t, size_t*, size_t,
                                  size_t*, int64_t*, int64_t*);
void ggrs_ep_commit(void*);

void* ggrs_sync_new(int, int);
void ggrs_sync_free(void*);
void ggrs_sync_set_frame_delay(void*, int, int);
void ggrs_sync_reset_prediction(void*);
int64_t ggrs_sync_add_input(void*, int, int64_t, const uint8_t*);
int ggrs_sync_synchronized_inputs(void*, int64_t, const uint8_t*,
                                  const int64_t*, uint8_t*, int32_t*);
int ggrs_sync_confirmed_inputs(void*, int64_t, const uint8_t*,
                               const int64_t*, uint8_t*, int64_t*);
int ggrs_sync_set_last_confirmed(void*, int64_t);
int64_t ggrs_sync_check_consistency(void*, int64_t);
int64_t ggrs_sync_last_added(void*, int);
int64_t ggrs_sync_tail_frame(void*, int);
int ggrs_sync_confirmed_input(void*, int, int64_t, uint8_t*);
int ggrs_sync_queue_len(void);

int ggrs_ep_dump_send(void*, uint8_t*, size_t, size_t*);
int ggrs_ep_dump_recv(void*, uint8_t*, size_t, size_t*);

int64_t ggrs_ep_last_acked_frame(void*);
void ggrs_ep_stats(void*, uint64_t*);

// ---- batched socket datapath (net_batch.cpp, same .so; DESIGN.md §15) ----
int ggrs_net_recv_all(void*);
int ggrs_net_recv_count(void*);
int ggrs_net_datagram(void*, int, uint32_t*, uint16_t*, const uint8_t**,
                      uint32_t*);
int ggrs_net_stage(void*, uint32_t, uint16_t, const uint8_t*, size_t);
int ggrs_net_flush(void*);
void ggrs_net_stats(void*, uint64_t*);
}

namespace {

constexpr int64_t kNullFrame = -1;

// protocol.py constants, mirrored exactly
constexpr int64_t kShutdownTimerMs = 5000;
constexpr int64_t kPendingOutputSize = 128;
constexpr int64_t kRunningRetryMs = 200;
constexpr int64_t kKeepAliveMs = 200;
constexpr int64_t kQualityReportMs = 200;
constexpr int kFrameWindow = 30;  // time_sync.py FRAME_WINDOW_SIZE

// bank-level return codes (mirrored in _native.py as BANK_ERR_*).
// kBankErrCmd is the ONLY whole-bank failure left: a malformed command
// stream means the Python builder itself is broken and no per-session
// blame is possible.  Every other code is a PER-SLOT fault, reported in
// that session's output record (err field) while the rest of the bank
// ticks normally — the supervision layer in host_bank.py quarantines the
// slot and evicts it to the Python fallback.
constexpr int kBankOk = 0;
constexpr int kBankErrCmd = -60;         // malformed command stream (fatal)
constexpr int kBankErrLandedSplit = -70; // local inputs landed on != frames
constexpr int kBankErrSync = -71;        // sync-core op failed (assert parity)
constexpr int kBankErrSyncInputs = -72;  // synchronized_inputs failed
constexpr int kBankErrConfirm = -73;     // set_last_confirmed invariant
constexpr int kBankErrNoPlayers = -74;   // every player disconnected
constexpr int kBankErrSequence = -75;    // remote input frame gap (assert)
constexpr int kBankErrInjected = -76;    // chaos-harness simulated fault
constexpr int kBankErrSpecStream = -77;  // confirmed-input fan-out failed
constexpr int kBankErrIo = -78;          // batched socket I/O failed fatally

// net_batch.cpp return codes the bank interprets
constexpr int kNetOk = 0;
constexpr int kNumNetStats = 22;

// address key for the native inbound routing tables: s_addr (as stored,
// network order) in the low 32 bits, host-order port above.  kNoAddr marks
// an endpoint the pool never mapped (its datagrams stay on the Python
// shuttle — unreachable when the pool attaches a socket, kept as a guard).
inline uint64_t addr_key(uint32_t ip, uint16_t port) {
  return static_cast<uint64_t>(ip) | (static_cast<uint64_t>(port) << 32);
}
constexpr uint64_t kNoAddr = ~uint64_t{0};

// command flags (host_bank.py mirrors)
constexpr uint8_t kFlagInputs = 1;  // local inputs present -> advance runs
constexpr uint8_t kFlagSkip = 2;    // slot quarantined/evicted: no fields
                                    // follow; emit a status-only record
constexpr uint8_t kFlagStaged = 4;  // local inputs were staged natively via
                                    // ggrs_bank_stage_inputs: NO inline
                                    // input bytes follow the flag byte

// ---- batched input staging (descriptor plane, DESIGN.md §21) ------------
// ggrs_bank_stage_inputs accepts ONE packed table per pool tick staging
// every slot's local inputs before the crossing: a fixed-stride descriptor
// table (the tick output's packed-header idiom) whose records jump into a shared
// payload blob — variable-length-ready even though today every record's
// len must equal the slot's input_size.  Stride and field offsets are
// mirrored by _native.BANK_STAGE_FIELDS; ggrs_bank_stage_stride() is the
// presence/version probe for the whole descriptor plane (staging entry,
// request-descriptor table, harvest staged tail).
//   u32 slot, i32 handle, i64 frame (reserved; kNullFrame = "this tick"),
//   u32 off, u32 len
constexpr size_t kStageStride = 24;

// ---- per-slot request descriptor table (descriptor plane, §21) ----------
// A SECOND fixed-stride table follows the header table: one kReqStride
// record per session describing the tick's request program so the pool —
// and BatchedRequestExecutor — can build the device dispatch (program
// selection, frames, input offsets) from flat NumPy reads, constructing
// zero GgrsRequest objects on fast-path slots.  Patterns:
//   kReqQuiet    ops are exactly [save f, advance]          (the steady state)
//   kReqResim    ops are [load f, adv, (save, adv)*, save]  (+ trailing adv)
//                with sequential save frames f+1.. — the rollback resim
//   kReqSaveOnly ops are exactly [save f]                   (prediction limit)
//   kReqEmpty    no ops (skip / faulted records)
//   kReqOther    anything else (frame-0 double save, future shapes):
//                consumers fall back to the generic op decoder
// Fields (offsets mirrored by _native.BANK_REQ_FIELDS):
//   u8 pattern, u8 rflags (bit0 = the tick ended on an advance op),
//   u16 n_adv, u32 adv_off (record-relative offset of the FIRST advance
//   op's status bytes), u32 adv_stride (byte distance between consecutive
//   advances' status bytes), u32 ops_end (record-relative offset just past
//   the ops section — where the outbound sections start), i64 frame (save
//   frame for quiet/save-only, load frame for resim, kNullFrame otherwise)
constexpr size_t kReqStride = 24;
constexpr uint8_t kReqOther = 0;
constexpr uint8_t kReqQuiet = 1;
constexpr uint8_t kReqResim = 2;
constexpr uint8_t kReqSaveOnly = 3;
constexpr uint8_t kReqEmpty = 4;
constexpr uint8_t kReqFlagTrailingAdv = 1;

// ---- packed per-tick output header (DESIGN.md §19) ----------------------
// The tick output now LEADS with one fixed-stride record per session — a
// flat little-endian table the pool reads with a handful of NumPy ops to
// classify all B slots before parsing any body bytes.  A slot whose flags
// say "live, nothing dirty, no events/spectators/consensus" takes the
// pool's vectorized fast path: pooled request objects refilled from the
// ops section, the events/mirror/spectator sections jumped via rec_len.
// kHdrQuiet + save_frame label the canonical [save, advance] tick shape —
// classification metadata for diagnostics and future specialized
// decoders; the current fast path decodes op shapes generically.  Stride
// and flag values are mirrored by _native.BANK_HDR_*;
// ggrs_bank_hdr_stride() is the presence/version probe (absent symbol =
// pre-header layout).
constexpr size_t kHdrStride = 48;
constexpr uint32_t kHdrLive = 1;        // stepped this tick and err == 0
constexpr uint32_t kHdrQuiet = 2;       // ops are exactly [save, advance]
constexpr uint32_t kHdrEvents = 4;      // n_events > 0
constexpr uint32_t kHdrSpec = 8;        // spectator endpoints / streams /
                                        // events present on this record
constexpr uint32_t kHdrConsensus = 16;  // consensus_pending
constexpr uint32_t kHdrDirty = 32;      // a status mirror changed this tick
                                        // (endpoint state, peer/local disc)
constexpr uint32_t kHdrOut = 64;        // outbound sections non-empty
constexpr uint32_t kHdrSkip = 128;      // cmd said skip (status-only record)
constexpr uint32_t kHdrConf = 256;      // journal-tap records present

inline void hdr_patch(std::vector<uint8_t>* o, size_t off, uint32_t flags,
                      uint32_t rec_len, int32_t err, int32_t frames_ahead,
                      int64_t landed, int64_t current, int64_t confirmed,
                      int64_t save_frame) {
  uint8_t* p = o->data() + off;
  auto w32 = [&p](size_t at, uint32_t v) {
    for (int i = 0; i < 4; ++i) p[at + i] = (v >> (8 * i)) & 0xFF;
  };
  auto w64 = [&p](size_t at, uint64_t v) {
    for (int i = 0; i < 8; ++i) p[at + i] = (v >> (8 * i)) & 0xFF;
  };
  w32(0, flags);
  w32(4, rec_len);
  w32(8, static_cast<uint32_t>(err));
  w32(12, static_cast<uint32_t>(frames_ahead));
  w64(16, static_cast<uint64_t>(landed));
  w64(24, static_cast<uint64_t>(current));
  w64(32, static_cast<uint64_t>(confirmed));
  w64(40, static_cast<uint64_t>(save_frame));
}

struct ReqDesc {
  uint8_t pattern = kReqEmpty;
  uint8_t rflags = 0;
  uint16_t n_adv = 0;
  uint32_t adv_off = 0;     // record-relative (the body prefix is 35 bytes)
  uint32_t adv_stride = 0;
  uint32_t ops_end = 35;    // record-relative end of the ops section
  int64_t frame = kNullFrame;
};

void req_patch(std::vector<uint8_t>* o, size_t off, const ReqDesc& d) {
  uint8_t* p = o->data() + off;
  p[0] = d.pattern;
  p[1] = d.rflags;
  p[2] = d.n_adv & 0xFF;
  p[3] = d.n_adv >> 8;
  auto w32 = [&p](size_t at, uint32_t v) {
    for (int i = 0; i < 4; ++i) p[at + i] = (v >> (8 * i)) & 0xFF;
  };
  w32(4, d.adv_off);
  w32(8, d.adv_stride);
  w32(12, d.ops_end);
  uint64_t u = static_cast<uint64_t>(d.frame);
  for (int i = 0; i < 8; ++i) p[16 + i] = (u >> (8 * i)) & 0xFF;
}

inline int64_t ops_i64_at(const std::vector<uint8_t>& ops, size_t at) {
  uint64_t u = 0;
  for (int i = 0; i < 8; ++i) {
    u |= static_cast<uint64_t>(ops[at + i]) << (8 * i);
  }
  return static_cast<int64_t>(u);
}

// Classify one slot's ops byte stream into its request descriptor (§21).
// The body prefix is 35 bytes, so record-relative offsets are ops-relative
// offsets + 35.  Unrecognized shapes (frame-0 double save, anything a
// future bank emits) land on kReqOther — consumers use the generic op
// decoder, never a wrong descriptor.
ReqDesc classify_ops(const std::vector<uint8_t>& ops, uint16_t n_ops,
                     int players, int isize) {
  ReqDesc d;
  d.ops_end = static_cast<uint32_t>(35 + ops.size());
  const size_t adv_size =
      1 + static_cast<size_t>(players) * (1 + static_cast<size_t>(isize));
  if (n_ops == 0) {
    d.pattern = kReqEmpty;
    return d;
  }
  // allocation-free fast exits for the shapes that dominate every tick
  // (this runs per slot INSIDE the crossing; the generic walk below uses
  // reused thread_local scratch and only runs for resim/other shapes)
  if (n_ops == 1 && ops[0] == 0 && ops.size() == 9) {
    d.pattern = kReqSaveOnly;  // [save f]: the prediction-limit tick
    d.frame = ops_i64_at(ops, 1);
    return d;
  }
  if (n_ops == 2 && ops[0] == 0 && ops.size() == 9 + adv_size &&
      ops[9] == 2) {
    d.pattern = kReqQuiet;  // [save f, advance]: the quiet steady state
    d.frame = ops_i64_at(ops, 1);
    d.n_adv = 1;
    d.adv_off = 35 + 10;
    d.rflags |= kReqFlagTrailingAdv;
    return d;
  }
  // generic trailing-advance detection (the "advanced" bit of the Python
  // reference decoder: the LAST op is an AdvanceFrame) — walk the ops
  size_t pos = 0;
  uint8_t last_kind = 255;
  static thread_local std::vector<std::pair<uint8_t, int64_t>> shape;
  static thread_local std::vector<size_t> adv_offs;
  shape.clear();     // (kind, frame|-1)
  adv_offs.clear();
  for (uint16_t i = 0; i < n_ops; ++i) {
    uint8_t kind = ops[pos];
    pos += 1;
    if (kind == 2) {
      adv_offs.push_back(pos);  // status bytes start here
      shape.emplace_back(kind, kNullFrame);
      pos += adv_size - 1;
    } else {
      shape.emplace_back(kind, ops_i64_at(ops, pos));
      pos += 8;
    }
    last_kind = kind;
  }
  if (last_kind == 2) d.rflags |= kReqFlagTrailingAdv;
  d.n_adv = static_cast<uint16_t>(adv_offs.size());
  if (!adv_offs.empty()) {
    d.adv_off = static_cast<uint32_t>(35 + adv_offs[0]);
    if (adv_offs.size() > 1) {
      d.adv_stride = static_cast<uint32_t>(adv_offs[1] - adv_offs[0]);
    }
  }
  // [save f]: the prediction-limit tick
  if (n_ops == 1 && shape[0].first == 0) {
    d.pattern = kReqSaveOnly;
    d.frame = shape[0].second;
    return d;
  }
  // [save f, advance]: the quiet steady state
  if (n_ops == 2 && shape[0].first == 0 && shape[1].first == 2) {
    d.pattern = kReqQuiet;
    d.frame = shape[0].second;
    return d;
  }
  // [load f, adv, (save, adv)*, save f+k] (+ optional trailing adv):
  // the rollback resim.  Saves must carry sequential frames f+1.. and the
  // advance spacing must be constant, else the shape is kReqOther.
  if (shape[0].first == 1 && n_ops >= 2 && shape[1].first == 2) {
    int64_t lf = shape[0].second;
    int64_t next_save = lf + 1;
    bool expect_adv = true;  // shape[1] onward alternates adv, save, ...
    bool ok = true;
    for (size_t i = 1; i < shape.size(); ++i) {
      if (expect_adv) {
        if (shape[i].first != 2) { ok = false; break; }
      } else {
        if (shape[i].first != 0 || shape[i].second != next_save) {
          ok = false;
          break;
        }
        next_save += 1;
      }
      expect_adv = !expect_adv;
    }
    // constant advance spacing (it is by construction: adv + save pairs)
    for (size_t i = 2; ok && i < adv_offs.size(); ++i) {
      if (adv_offs[i] - adv_offs[i - 1] != adv_offs[1] - adv_offs[0]) {
        ok = false;
      }
    }
    if (ok) {
      d.pattern = kReqResim;
      d.frame = lf;
      return d;
    }
  }
  d.pattern = kReqOther;
  return d;
}

// ---- in-crossing phase timers (tracing, DESIGN.md §14) ----------------
// When ggrs_bank_set_timing(1) is armed, the tick accumulates per-phase
// wall time (steady_clock, never the session clock) and appends a timing
// tail to the EXISTING tick output — tracing costs zero extra ctypes
// crossings and, when off, zero clock reads.  Phase order is mirrored by
// _native.BANK_PHASES; "other" is the remainder (cmd parse, skip records,
// memcpy) so the phases always sum to the measured in-crossing time.
enum BankPhase : int {
  kPhInbound = 0,   // datagram routing / ack / ring commit
  kPhTimers = 1,    // frame advantage, retry/quality/keep-alive/disconnect
  kPhCommit = 2,    // staged EvInput apply: remote-input enqueue into sync
  kPhRollback = 3,  // consistency check + rollback-resim descriptor build
  kPhOutbound = 4,  // local-input enqueue + outbound InputMessage assembly
  kPhFanout = 5,    // spectator fan-out + journal-tap staging
  kPhEmit = 6,      // output-record assembly (ops, sections, mirrors)
  kPhOther = 7,     // total - sum(above): parse, skip slots, bookkeeping
  kPhStaging = 8,   // ggrs_bank_stage_inputs time since the LAST tick —
                    // accumulated outside the tick window, reported on the
                    // next tick's tail (never part of the in-crossing sum)
  kNumPhases = 9,
};

inline uint64_t mono_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

struct PhaseTimer {
  bool on = false;
  uint64_t t = 0;
  uint64_t ns[kNumPhases] = {0};
  // re-base without attributing the gap (it lands in kPhOther)
  void skip() {
    if (on) t = mono_ns();
  }
  // attribute time since the last skip()/lap() to `ph`
  void lap(int ph) {
    if (on) {
      uint64_t n = mono_ns();
      ns[ph] += n - t;
      t = n;
    }
  }
};

// endpoint core codes (endpoint.cpp)
constexpr int kEpDrop = -30;
constexpr int kEpFallback = -31;

enum EpState : uint8_t { kRunning = 0, kDisconnected = 1, kShutdown = 2 };

// event kinds on the output stream (host_bank.py mirrors)
enum EvKind : uint8_t {
  kEvInterrupted = 1,
  kEvResumed = 2,
  kEvDisconnected = 3,
  kEvChecksum = 4,
  kEvInput = 5,  // internal only: applied natively, never surfaced
};

struct EpEvent {
  uint8_t kind;
  int32_t handle = -1;   // kEvInput: session player handle
  int64_t a = 0;         // frame / remaining ms
  uint64_t lo = 0, hi = 0;  // checksum halves
  uint32_t off = 0, len = 0;  // kEvInput: payload slice into evin_bytes
};

struct BankEndpoint {
  void* ep = nullptr;
  uint16_t magic = 0;
  std::vector<int32_t> handles;  // sorted remote player handles
  uint8_t state = kRunning;
  // timers / liveness (protocol.py timestamps)
  int64_t last_send = 0, last_recv = 0, last_input_recv = 0, last_quality = 0;
  int64_t shutdown_at = 0;
  bool notify_sent = false, disconnect_event_sent = false;
  int64_t rtt = 0;
  int64_t local_adv = 0, remote_adv = 0;
  // time_sync.py sliding windows with running sums
  int64_t ts_local[kFrameWindow] = {0}, ts_remote[kFrameWindow] = {0};
  int64_t ts_local_sum = 0, ts_remote_sum = 0;
  // what the peer last told us about every session player
  std::vector<uint8_t> peer_disc;
  std::vector<int64_t> peer_last;
  int64_t packets_sent = 0, bytes_sent = 0;
  int64_t stats_start = 0;  // protocol.py _stats_start_time (kbps window)
  // events persist across ticks (a post-drain event surfaces next tick,
  // exactly like protocol.py's deque)
  std::deque<EpEvent> events;
  std::vector<uint8_t> evin_bytes;  // per-tick EvInput payload scratch
  // per-tick outbound datagram streams, [u32 len][bytes]... each.  TWO
  // phases because the Python session flushes every endpoint's queue at
  // the end of poll_remote_clients and AGAIN per endpoint after
  // send_encoded_input — so the per-socket global order is [all endpoints'
  // poll messages][per-endpoint input messages], which multi-endpoint
  // sessions observe (and the fault-injecting net's rng stream feels)
  std::vector<uint8_t> out_poll, out_adv;
  // batched-I/O spectator deferral (the native twin of the pool mirror's
  // sp.deferred): fan-out datagrams assembled in the adv phase go out at
  // the NEXT tick, reproducing the Python session's flush order.  Framed
  // like the out streams; only populated for attached-socket slots.
  std::vector<uint8_t> deferred;
  std::vector<uint8_t>* cur_out = nullptr;
  uint32_t out_count = 0;

  int64_t ts_average() const {
    // int((remote_sum/30 - local_sum/30) / 2.0) — double ops term-for-term
    // with time_sync.py so truncation matches bit-exactly
    double local_avg = static_cast<double>(ts_local_sum) / kFrameWindow;
    double remote_avg = static_cast<double>(ts_remote_sum) / kFrameWindow;
    return static_cast<int64_t>((remote_avg - local_avg) / 2.0);
  }
};

struct BankSession {
  void* sync = nullptr;
  int num_players = 0, input_size = 0, max_prediction = 8, fps = 60;
  int64_t disconnect_timeout = 2000, notify_start = 500;
  std::vector<int32_t> local_handles;  // sorted
  std::vector<BankEndpoint> endpoints;
  // ---- broadcast fan-out (p2p.py's spectator relay, hub-owned policy) ----
  // spectator endpoints reuse the SAME endpoint-core mechanism as remotes
  // (pending window, delta base, InputMessage assembly) but carry the
  // confirmed inputs of ALL players and never feed the sync layer; each has
  // an independent ack/catchup window (its own core).  next_spectator_frame
  // mirrors p2p.py _next_spectator_frame; stream_confirmed additionally
  // stages the per-frame confirmed-input records into the tick OUTPUT (the
  // journal tap — zero extra crossings).
  std::vector<BankEndpoint> spectators;
  int64_t next_spectator_frame = 0;
  bool stream_confirmed = false;
  std::vector<uint8_t> conf_stream;  // per-tick staged journal records
  uint32_t conf_count = 0;
  int64_t conf_start = kNullFrame;
  std::vector<uint8_t> local_disc;
  std::vector<int64_t> local_last;
  int64_t current_frame = 0;
  int64_t last_confirmed = kNullFrame;
  int64_t disconnect_frame = kNullFrame;
  // ---- observability accumulators (ggrs_bank_stats) ----
  // monotonic; read-only for the harvest, never consulted by the tick
  uint64_t stat_ticks = 0;            // ticks this slot was actually stepped
  uint64_t stat_rollbacks = 0;        // rollback decisions executed
  uint64_t stat_rollback_frames = 0;  // total frames resimulated
  uint64_t stat_max_rollback = 0;     // deepest single rollback
  uint64_t stat_faults = 0;           // per-slot faults reported (err != 0)
  // ---- batched socket datapath (ggrs_bank_attach_socket) ----
  // net: a net_batch.cpp NetBatch borrowed from the pool (never owned or
  // freed here); ep_keys/spec_keys: inbound routing tables, indexed like
  // endpoints/spectators, filled by ggrs_bank_map_addr
  void* net = nullptr;
  std::vector<uint64_t> ep_keys;
  std::vector<uint64_t> spec_keys;
  int pending_io_err = 0;  // fatal recv errno from the pump's pre-drain
  // ---- batched input staging (ggrs_bank_stage_inputs, §21) ----
  // staged_local holds one input_size blob per local handle (sorted-handle
  // order, the same layout the inline cmd bytes use); the mask/count track
  // which handles are staged.  Cleared when the tick's trailing advance
  // consumes them (the Python reference's `if advanced: staged.clear()`),
  // or at slot-tick start when the cmd chose the inline path instead
  // (stale native staging must never leak into a later tick).  A FAULTED
  // tick keeps them: eviction re-feeds staged inputs to the fallback
  // session, and the harvest's staged tail is how it reads them.
  std::vector<uint8_t> staged_local;
  std::vector<uint8_t> staged_mask;
  int staged_count = 0;
  // status-mirror dirtiness (the header's kHdrDirty bit): set whenever an
  // endpoint/spectator STATE or a disc flag changes — the pool's fast path
  // skips the positional mirror parse only while this stays clear.
  // peer_last/local_last ratchets are deliberately NOT dirty: the policy
  // reads them only on event/consensus/fault ticks (always slow-parsed),
  // and the harvest carries the authoritative copy for eviction/export.
  // Starts true so the pool's first parse initializes its mirrors.
  bool dirty = true;
  // scratch
  std::vector<uint8_t> sync_buf;     // players * input_size
  std::vector<int32_t> status_buf;   // players
  std::vector<int64_t> frame_buf;    // players (confirmed_inputs out_frames)
  std::vector<uint8_t> payload;      // joined local-input payload
  std::vector<uint8_t> spec_payload; // joined all-player fan-out payload
};

struct Bank {
  std::vector<BankSession*> sessions;
  // endpoint-core receive staging (NativeEndpointCore's caps)
  std::vector<uint8_t> recv_out = std::vector<uint8_t>(size_t{1} << 16);
  std::vector<size_t> recv_sizes = std::vector<size_t>(512);
  std::vector<uint8_t> emit_buf = std::vector<uint8_t>(size_t{1} << 12);
  std::vector<uint8_t> out;  // tick output, memcpy'd to the caller
  // tracing (DESIGN.md §14): armed by ggrs_bank_set_timing; per-tick
  // phase ns ride the tick output, the cumulative totals ride the stats
  // output — neither adds a crossing
  bool timing = false;
  uint64_t timed_ticks = 0;
  uint64_t phase_total[kNumPhases] = {0};
  // staging wall time accrued by ggrs_bank_stage_inputs since the last
  // tick (timing armed only); flushed into the next tick's timing tail as
  // the kPhStaging entry
  uint64_t staging_pending = 0;
};

// ---- little-endian put/get over byte vectors -----------------------------

void put_u8(std::vector<uint8_t>* b, uint8_t v) { b->push_back(v); }
void put_u16(std::vector<uint8_t>* b, uint16_t v) {
  b->push_back(v & 0xFF);
  b->push_back(v >> 8);
}
void put_u32(std::vector<uint8_t>* b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b->push_back((v >> (8 * i)) & 0xFF);
}
void put_i64(std::vector<uint8_t>* b, int64_t v) {
  uint64_t u = static_cast<uint64_t>(v);
  for (int i = 0; i < 8; ++i) b->push_back((u >> (8 * i)) & 0xFF);
}
void put_u64(std::vector<uint8_t>* b, uint64_t u) {
  for (int i = 0; i < 8; ++i) b->push_back((u >> (8 * i)) & 0xFF);
}
void put_raw(std::vector<uint8_t>* b, const uint8_t* p, size_t n) {
  b->insert(b->end(), p, p + n);
}

struct CmdReader {
  const uint8_t* p;
  size_t len, pos = 0;
  bool ok = true;
  bool need(size_t n) {
    if (pos + n > len) { ok = false; return false; }
    return true;
  }
  uint8_t u8() { if (!need(1)) return 0; return p[pos++]; }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = p[pos] | (p[pos + 1] << 8);
    pos += 2;
    return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= static_cast<uint32_t>(p[pos + i]) << (8 * i);
    pos += 4;
    return v;
  }
  int64_t i64() {
    if (!need(8)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= static_cast<uint64_t>(p[pos + i]) << (8 * i);
    pos += 8;
    return static_cast<int64_t>(v);
  }
  const uint8_t* raw(size_t n) {
    if (!need(n)) return nullptr;
    const uint8_t* r = p + pos;
    pos += n;
    return r;
  }
};

// ---- small-message assembly (byte-identical to messages.py encoders) -----

void queue_bytes(BankEndpoint* ep, int64_t now, const uint8_t* p, size_t n) {
  ep->packets_sent += 1;
  ep->last_send = now;
  ep->bytes_sent += static_cast<int64_t>(n);
  put_u32(ep->cur_out, static_cast<uint32_t>(n));
  put_raw(ep->cur_out, p, n);
  ep->out_count += 1;
}

void queue_small(BankEndpoint* ep, int64_t now, const Writer& w) {
  queue_bytes(ep, now, w.buf.data(), w.buf.size());
}

void msg_header(Writer* w, uint16_t magic, uint8_t tag) {
  w->u8(magic & 0xFF);
  w->u8(magic >> 8);
  w->u8(tag);
}

void queue_input_ack(BankEndpoint* ep, int64_t now, int64_t ack_frame) {
  Writer w;
  msg_header(&w, ep->magic, kTagInputAck);
  w.svarint(ack_frame);
  queue_small(ep, now, w);
}

void queue_quality_report(BankEndpoint* ep, int64_t now) {
  // protocol.py _send_quality_report: clamp to i16, ping = clock()
  int64_t adv = ep->local_adv;
  if (adv < -32768) adv = -32768;
  if (adv > 32767) adv = 32767;
  Writer w;
  msg_header(&w, ep->magic, kTagQualityReport);
  uint16_t a = static_cast<uint16_t>(static_cast<int16_t>(adv));
  w.u8(a & 0xFF);
  w.u8(a >> 8);
  uint64_t ping = static_cast<uint64_t>(now);
  for (int i = 0; i < 8; ++i) w.u8((ping >> (8 * i)) & 0xFF);
  queue_small(ep, now, w);
}

void queue_quality_reply(BankEndpoint* ep, int64_t now, uint64_t pong) {
  Writer w;
  msg_header(&w, ep->magic, kTagQualityReply);
  for (int i = 0; i < 8; ++i) w.u8((pong >> (8 * i)) & 0xFF);
  queue_small(ep, now, w);
}

void queue_keep_alive(BankEndpoint* ep, int64_t now) {
  Writer w;
  msg_header(&w, ep->magic, kTagKeepAlive);
  queue_small(ep, now, w);
}

void queue_sync_reply(BankEndpoint* ep, int64_t now, uint64_t nonce) {
  Writer w;
  msg_header(&w, ep->magic, kTagSyncReply);
  w.uvarint(nonce);
  queue_small(ep, now, w);
}

// protocol.py _mark_alive
void mark_alive(BankEndpoint* ep, int64_t now) {
  ep->last_recv = now;
  if (ep->notify_sent && ep->state == kRunning) {
    ep->notify_sent = false;
    ep->events.push_back(EpEvent{kEvResumed});
  }
}

// protocol.py _send_pending_output over the native emit
void send_pending_output(Bank* bank, BankSession* s, BankEndpoint* ep,
                         int64_t now) {
  while (true) {
    size_t out_len = 0;
    int rc = ggrs_ep_emit_input(
        ep->ep, ep->magic, s->local_disc.data(),
        reinterpret_cast<const uint8_t*>(s->local_last.data()),
        s->num_players, ep->state == kDisconnected ? 1 : 0,
        bank->emit_buf.data(), bank->emit_buf.size(), &out_len);
    if (rc == kErrBufferTooSmall) {
      bank->emit_buf.resize(bank->emit_buf.size() * 4);
      continue;
    }
    if (rc != kOk || out_len == 0) return;  // errors unreachable: bank
    // sessions obey the wire player cap and the pending-head invariant
    queue_bytes(ep, now, bank->emit_buf.data(), out_len);
    return;
  }
}

// Inner per-player framing of one received frame payload: exactly
// len(handles) uvarint-prefixed blobs, each input_size bytes, nothing
// trailing (protocol.py _decode_player_bytes + fixed-size input_decode).
bool inner_framing_ok(const uint8_t* p, size_t n, size_t n_handles,
                      size_t input_size) {
  Reader r{p, n};
  for (size_t i = 0; i < n_handles; ++i) {
    const uint8_t* blob;
    size_t blob_len;
    if (r.byte_string(&blob, &blob_len) != kOk) return false;
    if (blob_len != input_size) return false;
  }
  return r.remaining() == 0;
}

// One inbound datagram for one endpoint — the fused receive of
// protocol.py handle_datagram, minus the Python-object escape hatches.
void process_datagram(Bank* bank, BankSession* s, BankEndpoint* ep,
                      int64_t now, const uint8_t* data, size_t len) {
  if (ep->state == kShutdown) return;
  if (len < 3) return;  // no tag byte: undecodable, drop
  uint8_t tag = data[2];
  Reader r{data, len};
  const uint8_t* hdr;
  r.take(3, &hdr);  // magic is carried but never verified (fork parity)

  switch (tag) {
    case kTagInput: {
      uint16_t magic;
      uint8_t dreq = 0;
      uint8_t disc[kMaxPlayersOnWire];
      int64_t frames[kMaxPlayersOnWire];
      int32_t n_status = 0;
      int64_t start_frame = 0;
      size_t out_count = 0;
      int64_t first_new = kNullFrame, new_last_recv = kNullFrame;
      int rc = ggrs_ep_handle_input_datagram(
          ep->ep, data, len, &magic, &dreq, disc, frames, &n_status,
          &start_frame, bank->recv_out.data(), bank->recv_out.size(),
          bank->recv_sizes.data(), bank->recv_sizes.size(), &out_count,
          &first_new, &new_last_recv);
      if (rc == kEpFallback) return;  // needs Python's unbounded decode:
      // unreachable from an honest bank peer (fixed-size inputs, 128-deep
      // window); dropping is the documented divergence
      if (rc != kOk && rc != kEpDrop) return;  // malformed: drop whole
      mark_alive(ep, now);
      if (dreq) {
        if (ep->state != kDisconnected && !ep->disconnect_event_sent) {
          ep->events.push_back(EpEvent{kEvDisconnected});
          ep->disconnect_event_sent = true;
        }
      } else {
        if (n_status != s->num_players) return;  // malformed: drop
        for (int32_t i = 0; i < n_status; ++i) {
          if (disc[i] && !ep->peer_disc[i]) {
            ep->peer_disc[i] = 1;
            s->dirty = true;  // the consensus policy reads this mirror
          }
          if (frames[i] > ep->peer_last[i]) ep->peer_last[i] = frames[i];
        }
      }
      if (rc == kEpDrop) return;  // gap / missing base: header-only packet
      // _finish_input: validate ALL inner framing before committing
      {
        size_t pos = 0;
        for (size_t i = 0; i < out_count; ++i) {
          if (!inner_framing_ok(bank->recv_out.data() + pos,
                                bank->recv_sizes[i], ep->handles.size(),
                                static_cast<size_t>(s->input_size))) {
            return;  // malformed inner frame: drop the packet whole
          }
          pos += bank->recv_sizes[i];
        }
      }
      ggrs_ep_commit(ep->ep);
      s->payload.clear();  // (reuse as nothing; commit clears staging)
      ep->last_input_recv = now;
      // stage EvInput per (frame, handle) with each handle's payload bytes
      {
        size_t pos = 0;
        for (size_t i = 0; i < out_count; ++i) {
          Reader fr{bank->recv_out.data() + pos, bank->recv_sizes[i]};
          int64_t frame = first_new + static_cast<int64_t>(i);
          for (size_t h = 0; h < ep->handles.size(); ++h) {
            const uint8_t* blob;
            size_t blob_len;
            fr.byte_string(&blob, &blob_len);  // validated above
            EpEvent ev{kEvInput};
            ev.handle = ep->handles[h];
            ev.a = frame;
            ev.off = static_cast<uint32_t>(ep->evin_bytes.size());
            ev.len = static_cast<uint32_t>(blob_len);
            put_raw(&ep->evin_bytes, blob, blob_len);
            ep->events.push_back(ev);
          }
          pos += bank->recv_sizes[i];
        }
      }
      // ack what we have now (protocol.py acks with the mirror, which only
      // moves when new frames landed)
      int64_t ack = out_count ? new_last_recv : ggrs_ep_last_recv_frame(ep->ep);
      queue_input_ack(ep, now, ack);
      return;
    }
    case kTagInputAck: {
      int64_t ack_frame;
      if (r.svarint(&ack_frame) != kOk || r.remaining() != 0) return;
      mark_alive(ep, now);
      ggrs_ep_ack(ep->ep, ack_frame);
      return;
    }
    case kTagQualityReport: {
      const uint8_t* p;
      if (r.take(10, &p) != kOk || r.remaining() != 0) return;
      int16_t adv;
      std::memcpy(&adv, p, 2);
      uint64_t ping;
      std::memcpy(&ping, p + 2, 8);
      mark_alive(ep, now);
      ep->remote_adv = adv;
      queue_quality_reply(ep, now, ping);
      return;
    }
    case kTagQualityReply: {
      const uint8_t* p;
      if (r.take(8, &p) != kOk || r.remaining() != 0) return;
      uint64_t pong;
      std::memcpy(&pong, p, 8);
      mark_alive(ep, now);
      if (static_cast<uint64_t>(now) >= pong) {
        ep->rtt = now - static_cast<int64_t>(pong);
      }
      return;
    }
    case kTagChecksumReport: {
      int64_t frame;
      const uint8_t* p;
      if (r.svarint(&frame) != kOk || r.take(16, &p) != kOk ||
          r.remaining() != 0) {
        return;
      }
      mark_alive(ep, now);
      EpEvent ev{kEvChecksum};
      ev.a = frame;
      std::memcpy(&ev.lo, p, 8);
      std::memcpy(&ev.hi, p + 8, 8);
      ep->events.push_back(ev);
      return;
    }
    case kTagKeepAlive: {
      if (r.remaining() != 0) return;
      mark_alive(ep, now);
      return;
    }
    case kTagSyncRequest: {
      uint64_t nonce;
      if (r.uvarint(&nonce) != kOk || r.remaining() != 0) return;
      mark_alive(ep, now);
      queue_sync_reply(ep, now, nonce);  // always answered, any live state
      return;
    }
    case kTagSyncReply: {
      uint64_t nonce;
      if (r.uvarint(&nonce) != kOk || r.remaining() != 0) return;
      mark_alive(ep, now);  // running endpoints ignore late replies
      return;
    }
    default:
      return;  // unknown tag: drop
  }
}

// protocol.py poll() timers, RUNNING/DISCONNECTED branches (the bank never
// hosts SYNCHRONIZING endpoints — handshake sessions stay on the fallback)
void poll_timers(Bank* bank, BankSession* s, BankEndpoint* ep, int64_t now) {
  if (ep->state == kRunning) {
    if (ep->last_input_recv + kRunningRetryMs < now) {
      send_pending_output(bank, s, ep, now);
      ep->last_input_recv = now;
    }
    if (ep->last_quality + kQualityReportMs < now) {
      ep->last_quality = now;
      queue_quality_report(ep, now);
    }
    if (ep->last_send + kKeepAliveMs < now) {
      queue_keep_alive(ep, now);
    }
    if (!ep->notify_sent && ep->last_recv + s->notify_start < now) {
      EpEvent ev{kEvInterrupted};
      ev.a = s->disconnect_timeout - s->notify_start;
      ep->events.push_back(ev);
      ep->notify_sent = true;
    }
    if (!ep->disconnect_event_sent &&
        ep->last_recv + s->disconnect_timeout < now) {
      ep->events.push_back(EpEvent{kEvDisconnected});
      ep->disconnect_event_sent = true;
    }
  } else if (ep->state == kDisconnected) {
    if (ep->shutdown_at < now) {
      ep->state = kShutdown;
      s->dirty = true;
    }
  }
}

// p2p.py _disconnect_player_at_frame for a remote endpoint, applied as a
// ctrl op (Python policy decided it last tick)
void disconnect_endpoint(BankSession* s, BankEndpoint* ep, int64_t now,
                         int64_t last_frame) {
  for (int32_t h : ep->handles) s->local_disc[h] = 1;
  if (ep->state != kShutdown) {
    ep->state = kDisconnected;
    ep->shutdown_at = now + kShutdownTimerMs;
  }
  s->dirty = true;  // local_disc + endpoint state changed
  if (s->current_frame > last_frame) s->disconnect_frame = last_frame + 1;
}

// p2p.py _update_player_disconnects trigger condition — the DETECTION is
// mechanism (a pure read); the action stays in Python via next tick's ctrl
bool consensus_pending(const BankSession* s) {
  for (int h = 0; h < s->num_players; ++h) {
    bool queue_connected = true;
    int64_t min_confirmed = INT64_MAX;
    for (const BankEndpoint& ep : s->endpoints) {
      if (ep.state != kRunning) continue;
      if (ep.peer_disc[h]) queue_connected = false;
      if (ep.peer_last[h] < min_confirmed) min_confirmed = ep.peer_last[h];
    }
    bool local_connected = !s->local_disc[h];
    int64_t local_min = s->local_last[h];
    if (local_connected && local_min < min_confirmed) min_confirmed = local_min;
    if (!queue_connected && (local_connected || local_min > min_confirmed)) {
      return true;
    }
  }
  return false;
}

// p2p.py _max_frame_advantage: max time-sync average over endpoints with a
// connected handle, 0 when none
int64_t max_frame_advantage(const BankSession* s) {
  int64_t frames_ahead = 0;
  bool any = false;
  for (const BankEndpoint& ep : s->endpoints) {
    bool has_connected = false;
    for (int32_t h : ep.handles) {
      if (!s->local_disc[h]) has_connected = true;
    }
    if (!has_connected) continue;
    int64_t adv = ep.ts_average();
    if (!any || adv > frames_ahead) frames_ahead = adv;
    any = true;
  }
  return frames_ahead;
}

// p2p.py _send_confirmed_inputs_to_spectators: forward every newly
// confirmed frame's inputs (for ALL players) to each running spectator
// endpoint, and stage the same records for the journal tap.  Runs BEFORE
// the watermark discard drops those inputs, with the UNCLAMPED confirmed
// frame (the Python path sends with confirmed_frame before the
// current-frame clamp — reachable with input delay).  One datagram per
// newly confirmed frame per spectator, exactly like the Python loop.
int fan_out_confirmed(Bank* bank, BankSession* s, int64_t now,
                      int64_t confirmed) {
  const int players = s->num_players;
  const size_t isize = static_cast<size_t>(s->input_size);
  while (s->next_spectator_frame <= confirmed) {
    int64_t f = s->next_spectator_frame;
    int rc = ggrs_sync_confirmed_inputs(
        s->sync, f, s->local_disc.data(), s->local_last.data(),
        s->sync_buf.data(), s->frame_buf.data());
    if (rc != kOk) return kBankErrSpecStream;
    if (!s->spectators.empty()) {
      // joined payload over all players (encode_local_inputs: blanks for
      // disconnected players encode as the zeroed default)
      Writer w;
      for (int p = 0; p < players; ++p) {
        w.uvarint(static_cast<uint64_t>(isize));
        w.raw(s->sync_buf.data() + static_cast<size_t>(p) * isize, isize);
      }
      s->spec_payload.assign(w.buf.begin(), w.buf.end());
      for (BankEndpoint& ep : s->spectators) {
        if (ep.state != kRunning) continue;  // send_input's RUNNING gate
        int64_t pending = ggrs_ep_push(ep.ep, f, s->spec_payload.data(),
                                       s->spec_payload.size());
        if (pending > kPendingOutputSize && !ep.disconnect_event_sent) {
          // a viewer that never acks 128 inputs is a stuck spectator
          // (protocol.rs:441-445); the hub applies the disconnect next tick
          ep.events.push_back(EpEvent{kEvDisconnected});
        }
        send_pending_output(bank, s, &ep, now);
      }
    }
    if (s->stream_confirmed) {
      if (s->conf_count == 0) s->conf_start = f;
      for (int p = 0; p < players; ++p) {
        put_u8(&s->conf_stream, s->frame_buf[p] == kNullFrame ? 1 : 0);
      }
      put_raw(&s->conf_stream, s->sync_buf.data(),
              static_cast<size_t>(players) * isize);
      s->conf_count += 1;
    }
    s->next_spectator_frame += 1;
  }
  return kBankOk;
}

// Status-mirror tail shared by the normal and skip record paths: a field
// added to one but not the other would misalign Python's positional parse
// exactly and only during fault handling.
// Walk one phase's per-endpoint outbound streams and emit their datagram
// records (u16 ep, [u8 phase when tagged], u32 len, bytes), in endpoint
// order.  Shared by the remote sections and the spectator tail — the one
// definition of the stream-to-record rewrite.
void emit_out_records(std::vector<uint8_t>* o,
                      std::vector<BankEndpoint>& endpoints, int phase,
                      bool tag_phase, uint32_t* count) {
  for (size_t e = 0; e < endpoints.size(); ++e) {
    const std::vector<uint8_t>& stream =
        phase == 0 ? endpoints[e].out_poll : endpoints[e].out_adv;
    size_t pos = 0;
    while (pos < stream.size()) {
      uint32_t dlen = 0;
      for (int i = 0; i < 4; ++i) {
        dlen |= static_cast<uint32_t>(stream[pos + i]) << (8 * i);
      }
      pos += 4;
      put_u16(o, static_cast<uint16_t>(e));
      if (tag_phase) put_u8(o, static_cast<uint8_t>(phase));
      put_u32(o, dlen);
      put_raw(o, stream.data() + pos, dlen);
      pos += dlen;
      ++*count;
    }
  }
}

void patch_u16(std::vector<uint8_t>* o, size_t pos, uint32_t v) {
  (*o)[pos] = v & 0xFF;
  (*o)[pos + 1] = (v >> 8) & 0xFF;
}

// One outbound-datagram section (u16 count, then u16 ep / u32 len / bytes
// per datagram) for one phase's streams, in endpoint order.
void emit_out_section(std::vector<uint8_t>* o,
                      std::vector<BankEndpoint>& endpoints, int phase) {
  uint32_t count = 0;
  size_t count_pos = o->size();
  put_u16(o, 0);  // patched below
  emit_out_records(o, endpoints, phase, false, &count);
  patch_u16(o, count_pos, count);
}

// Broadcast tail of every session record (normal, faulted, and skip paths
// all emit it so the positional parse never misaligns): the spectator
// status mirror, the phase-tagged spectator outbound streams, the hub
// event stream, and the journal tap's confirmed-input records.  A non-live
// record (skip / fault) carries states only — its streams were suppressed.
// An attached-socket slot (io_slot) already sent/deferred its streams
// through the NetBatch, so n_spec_out is 0 while the hub events and the
// journal tap records still ride the record.
void emit_spectator_tail(std::vector<uint8_t>* o, BankSession* s, bool live,
                         const std::vector<uint8_t>* spec_events = nullptr,
                         uint16_t n_spec_events = 0, bool io_slot = false) {
  put_i64(o, s->next_spectator_frame);
  put_u8(o, static_cast<uint8_t>(s->spectators.size()));
  for (BankEndpoint& sp : s->spectators) {
    put_u8(o, sp.state);
    put_i64(o, ggrs_ep_last_acked_frame(sp.ep));
  }
  if (!live) {
    put_u16(o, 0);  // n_spec_out
    put_u16(o, 0);  // n_spec_events
    put_u16(o, 0);  // n_conf
    return;
  }
  if (io_slot) {
    put_u16(o, 0);  // streams already went through the NetBatch
  } else {
    uint32_t count = 0;
    size_t count_pos = o->size();
    put_u16(o, 0);  // n_spec_out, patched below
    for (int phase = 0; phase < 2; ++phase) {
      emit_out_records(o, s->spectators, phase, true, &count);
    }
    patch_u16(o, count_pos, count);
  }
  put_u16(o, n_spec_events);
  if (spec_events != nullptr) {
    put_raw(o, spec_events->data(), spec_events->size());
  }
  put_u16(o, static_cast<uint16_t>(s->conf_count));
  if (s->conf_count > 0) {
    put_i64(o, s->conf_start);
    put_raw(o, s->conf_stream.data(), s->conf_stream.size());
  }
  return;
}

// ---- batched socket datapath helpers (DESIGN.md §15) ---------------------

inline uint64_t key_at(const std::vector<uint64_t>& keys, size_t i) {
  return i < keys.size() ? keys[i] : kNoAddr;
}

// Stage one framed out stream ([u32 len][bytes]*) to `key` on the slot's
// NetBatch.  Unmapped endpoints are skipped — unreachable when the pool
// attached the socket (it maps every address first), kept as a guard.
void stage_stream_io(BankSession* s, uint64_t key,
                     const std::vector<uint8_t>& stream) {
  if (key == kNoAddr || stream.empty()) return;
  uint32_t ip = static_cast<uint32_t>(key & 0xFFFFFFFFu);
  uint16_t port = static_cast<uint16_t>(key >> 32);
  size_t pos = 0;
  while (pos + 4 <= stream.size()) {
    uint32_t dlen = 0;
    for (int i = 0; i < 4; ++i) {
      dlen |= static_cast<uint32_t>(stream[pos + i]) << (8 * i);
    }
    pos += 4;
    if (pos + dlen > stream.size()) break;  // corrupt framing: never stage
    // bytes past the stream (the header check above is just as defensive)
    ggrs_net_stage(s->net, ip, port, stream.data() + pos, dlen);
    pos += dlen;
  }
}

// The attached-socket outbound path, staged in EXACTLY the order the pool
// sends on the Python shuttle (host_bank._parse_output): every remote
// endpoint's poll-phase datagrams, then per spectator last tick's deferred
// fan-out followed by this tick's poll messages, then the remote adv-phase
// (input) datagrams; this tick's fan-out datagrams rotate into the
// deferral for the next tick.  One sendmmsg flush for the whole slot.
int stage_and_flush_io(BankSession* s) {
  for (size_t e = 0; e < s->endpoints.size(); ++e) {
    stage_stream_io(s, key_at(s->ep_keys, e), s->endpoints[e].out_poll);
  }
  for (size_t e = 0; e < s->spectators.size(); ++e) {
    BankEndpoint& sp = s->spectators[e];
    uint64_t key = key_at(s->spec_keys, e);
    stage_stream_io(s, key, sp.deferred);
    sp.deferred.clear();
    stage_stream_io(s, key, sp.out_poll);
  }
  for (size_t e = 0; e < s->endpoints.size(); ++e) {
    stage_stream_io(s, key_at(s->ep_keys, e), s->endpoints[e].out_adv);
  }
  for (BankEndpoint& sp : s->spectators) {
    sp.deferred.swap(sp.out_adv);
    sp.out_adv.clear();
  }
  return ggrs_net_flush(s->net) == kNetOk ? kBankOk : kBankErrIo;
}

void emit_status_mirrors(std::vector<uint8_t>* o, const BankSession* s) {
  put_u8(o, static_cast<uint8_t>(s->endpoints.size()));
  for (const BankEndpoint& ep : s->endpoints) {
    put_u8(o, ep.state);
    for (int h = 0; h < s->num_players; ++h) {
      put_u8(o, ep.peer_disc[h]);
      put_i64(o, ep.peer_last[h]);
    }
  }
  for (int h = 0; h < s->num_players; ++h) {
    put_u8(o, s->local_disc[h]);
    put_i64(o, s->local_last[h]);
  }
}

int advance_session(Bank* bank, BankSession* s, int64_t now,
                    const uint8_t* local_inputs, std::vector<uint8_t>* ops,
                    uint16_t* n_ops, int64_t* landed_out,
                    int64_t* frames_ahead_out, PhaseTimer* pt) {
  const int players = s->num_players;
  const int isize = s->input_size;
  pt->skip();

  // frame-0 initial save (p2p.py: save before anything else that tick)
  if (s->current_frame == 0) {
    put_u8(ops, 0);
    put_i64(ops, 0);
    ++*n_ops;
  }

  // confirmed frame: min last-received over connected players
  int64_t confirmed = INT64_MAX;
  for (int h = 0; h < players; ++h) {
    if (!s->local_disc[h] && s->local_last[h] < confirmed) {
      confirmed = s->local_last[h];
    }
  }
  if (confirmed == INT64_MAX) return kBankErrNoPlayers;

  // consistency check + rollback descriptor
  int64_t first_incorrect =
      ggrs_sync_check_consistency(s->sync, s->disconnect_frame);
  if (first_incorrect != kNullFrame) {
    if (first_incorrect < s->current_frame) {
      // _adjust_gamestate, non-sparse: load first_incorrect, resim forward
      int64_t frame_to_load = first_incorrect;
      int64_t count = s->current_frame - frame_to_load;
      s->stat_rollbacks += 1;
      s->stat_rollback_frames += static_cast<uint64_t>(count);
      if (static_cast<uint64_t>(count) > s->stat_max_rollback) {
        s->stat_max_rollback = static_cast<uint64_t>(count);
      }
      put_u8(ops, 1);
      put_i64(ops, frame_to_load);
      ++*n_ops;
      s->current_frame = frame_to_load;
      ggrs_sync_reset_prediction(s->sync);
      for (int64_t i = 0; i < count; ++i) {
        if (i > 0) {
          put_u8(ops, 0);
          put_i64(ops, s->current_frame);
          ++*n_ops;
        }
        int rc = ggrs_sync_synchronized_inputs(
            s->sync, s->current_frame, s->local_disc.data(),
            s->local_last.data(), s->sync_buf.data(), s->status_buf.data());
        if (rc != kOk) return kBankErrSyncInputs;
        s->current_frame += 1;
        put_u8(ops, 2);
        for (int p = 0; p < players; ++p) {
          put_u8(ops, static_cast<uint8_t>(s->status_buf[p]));
        }
        put_raw(ops, s->sync_buf.data(),
                static_cast<size_t>(players) * isize);
        ++*n_ops;
      }
    }
    s->disconnect_frame = kNullFrame;
  }

  // per-frame save of the current state (non-sparse mode)
  put_u8(ops, 0);
  put_i64(ops, s->current_frame);
  ++*n_ops;
  pt->lap(kPhRollback);

  // broadcast fan-out + journal tap: BEFORE set_last_confirmed discards the
  // inputs it would need (p2p.py sends to spectators at exactly this point)
  if (!s->spectators.empty() || s->stream_confirmed) {
    int rc = fan_out_confirmed(bank, s, now, confirmed);
    if (rc != kBankOk) return rc;
  }
  pt->lap(kPhFanout);

  // confirmed-frame watermark (policy minimums applied: non-sparse, so only
  // the never-past-current clamp)
  int64_t watermark =
      confirmed < s->current_frame ? confirmed : s->current_frame;
  if (ggrs_sync_set_last_confirmed(s->sync, watermark) != kOk) {
    return kBankErrConfirm;
  }
  s->last_confirmed = watermark;

  // the wait-recommendation read happens HERE in p2p.py
  // (_check_wait_recommendation), BEFORE send_encoded_input pushes this
  // tick's sample into the time-sync windows — sampling after the push
  // would let the recommendation see one tick into the future relative to
  // the per-session Python path
  *frames_ahead_out = max_frame_advantage(s);

  // register local inputs and send them
  bool all_landed = true;
  int64_t landed = kNullFrame;
  for (size_t i = 0; i < s->local_handles.size(); ++i) {
    int64_t rc = ggrs_sync_add_input(s->sync, s->local_handles[i],
                                     s->current_frame,
                                     local_inputs + i * isize);
    if (rc < kNullFrame) return kBankErrSync;
    if (rc != kNullFrame) {
      s->local_last[s->local_handles[i]] = rc;
      if (landed != kNullFrame && rc != landed) return kBankErrLandedSplit;
      landed = rc;
    } else {
      all_landed = false;
    }
  }
  *landed_out = landed;

  if (all_landed && !s->endpoints.empty() && !s->local_handles.empty()) {
    // join the per-player payload once (encode_local_inputs)
    s->payload.clear();
    {
      Writer w;
      for (size_t i = 0; i < s->local_handles.size(); ++i) {
        w.uvarint(static_cast<uint64_t>(isize));
        w.raw(local_inputs + i * isize, static_cast<size_t>(isize));
      }
      s->payload.assign(w.buf.begin(), w.buf.end());
    }
    for (BankEndpoint& ep : s->endpoints) {
      if (ep.state != kRunning) continue;  // send_encoded_input's gate
      // time_sync.advance_frame(frame, local_adv, remote_adv)
      int i = static_cast<int>(landed % kFrameWindow);
      if (i < 0) i += kFrameWindow;
      ep.ts_local_sum += ep.local_adv - ep.ts_local[i];
      ep.ts_local[i] = ep.local_adv;
      ep.ts_remote_sum += ep.remote_adv - ep.ts_remote[i];
      ep.ts_remote[i] = ep.remote_adv;
      int64_t pending = ggrs_ep_push(ep.ep, landed, s->payload.data(),
                                     s->payload.size());
      if (pending > kPendingOutputSize && !ep.disconnect_event_sent) {
        // protocol.py queues EvDisconnected; it drains NEXT tick's poll.
        // (The Python path does not set _disconnect_event_sent here; it
        // relies on the session reacting — mirror the queue exactly.)
        ep.events.push_back(EpEvent{kEvDisconnected});
      }
      send_pending_output(bank, s, &ep, now);
    }
  }

  // advance decision
  int64_t frames_ahead = s->last_confirmed == kNullFrame
                             ? s->current_frame
                             : s->current_frame - s->last_confirmed;
  if (frames_ahead < s->max_prediction) {
    int rc = ggrs_sync_synchronized_inputs(
        s->sync, s->current_frame, s->local_disc.data(), s->local_last.data(),
        s->sync_buf.data(), s->status_buf.data());
    if (rc != kOk) return kBankErrSyncInputs;
    s->current_frame += 1;
    put_u8(ops, 2);
    for (int p = 0; p < players; ++p) {
      put_u8(ops, static_cast<uint8_t>(s->status_buf[p]));
    }
    put_raw(ops, s->sync_buf.data(), static_cast<size_t>(players) * isize);
    ++*n_ops;
  }
  pt->lap(kPhOutbound);
  return kBankOk;
}

}  // namespace

extern "C" {

void* ggrs_bank_new(void) { return new (std::nothrow) Bank(); }

void ggrs_bank_free(void* ptr) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (!bank) return;
  for (BankSession* s : bank->sessions) {
    for (BankEndpoint& ep : s->endpoints) ggrs_ep_free(ep.ep);
    for (BankEndpoint& ep : s->spectators) ggrs_ep_free(ep.ep);
    ggrs_sync_free(s->sync);
    delete s;
  }
  delete bank;
}

// Returns the new session's index, or a negative error.
int64_t ggrs_bank_add_session(void* ptr, int num_players, int input_size,
                              int max_prediction, int fps,
                              int64_t disconnect_timeout_ms,
                              int64_t disconnect_notify_start_ms,
                              const int32_t* local_handles, int n_local,
                              int input_delay) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (num_players < 1 ||
      static_cast<size_t>(num_players) > kMaxPlayersOnWire ||
      input_size < 1 || input_size > 4096 || max_prediction < 1 ||
      n_local < 0 || n_local > num_players) {
    return kBankErrCmd;
  }
  void* sync = ggrs_sync_new(num_players, input_size);
  if (!sync) return kBankErrCmd;
  BankSession* s = new (std::nothrow) BankSession();
  if (!s) {
    ggrs_sync_free(sync);
    return kBankErrCmd;
  }
  s->sync = sync;
  s->num_players = num_players;
  s->input_size = input_size;
  s->max_prediction = max_prediction;
  s->fps = fps;
  s->disconnect_timeout = disconnect_timeout_ms;
  s->notify_start = disconnect_notify_start_ms;
  s->local_handles.assign(local_handles, local_handles + n_local);
  s->local_disc.assign(num_players, 0);
  s->local_last.assign(num_players, kNullFrame);
  s->sync_buf.resize(static_cast<size_t>(num_players) * input_size);
  s->status_buf.resize(num_players);
  s->frame_buf.resize(num_players);
  s->staged_local.assign(
      static_cast<size_t>(n_local) * static_cast<size_t>(input_size), 0);
  s->staged_mask.assign(static_cast<size_t>(n_local), 0);
  for (int32_t h : s->local_handles) {
    ggrs_sync_set_frame_delay(s->sync, h, input_delay);
  }
  bank->sessions.push_back(s);
  return static_cast<int64_t>(bank->sessions.size()) - 1;
}

// Returns the endpoint's index within the session, or a negative error.
// now_ms seeds every liveness timestamp, as PeerProtocol.__init__ does.
int64_t ggrs_bank_add_endpoint(void* ptr, int64_t session, uint16_t magic,
                               const int32_t* handles, int n_handles,
                               int64_t now_ms) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size() ||
      n_handles < 1) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  // bases: the joined default payload, per side's player count
  // (protocol.py: send over local players, receive over endpoint handles)
  Writer send_base, recv_base;
  std::vector<uint8_t> zeros(static_cast<size_t>(s->input_size), 0);
  for (size_t i = 0; i < s->local_handles.size(); ++i) {
    send_base.uvarint(static_cast<uint64_t>(s->input_size));
    send_base.raw(zeros.data(), zeros.size());
  }
  for (int i = 0; i < n_handles; ++i) {
    recv_base.uvarint(static_cast<uint64_t>(s->input_size));
    recv_base.raw(zeros.data(), zeros.size());
  }
  void* ep = ggrs_ep_new(send_base.buf.data(), send_base.buf.size(),
                         recv_base.buf.data(), recv_base.buf.size(),
                         s->max_prediction);
  if (!ep) return kBankErrCmd;
  s->endpoints.emplace_back();
  BankEndpoint& e = s->endpoints.back();
  e.ep = ep;
  e.magic = magic;
  e.handles.assign(handles, handles + n_handles);
  e.last_send = e.last_recv = e.last_input_recv = e.last_quality = now_ms;
  e.stats_start = now_ms;
  e.peer_disc.assign(s->num_players, 0);
  e.peer_last.assign(s->num_players, kNullFrame);
  return static_cast<int64_t>(s->endpoints.size()) - 1;
}

// Attach a spectator fan-out endpoint to a session (broadcast subsystem —
// ggrs_tpu_torch/broadcast/hub.py owns registration policy and address routing).
// The endpoint carries the confirmed inputs of ALL players (send base =
// num_players default payloads, like start_p2p_session's spectator
// endpoints); its ack/catchup window is independent of every other
// spectator's.  Returns the spectator index within the session, or a
// negative error.  now_ms seeds the liveness timers.  The hub must attach
// before any frame is confirmed (next_spectator_frame > 0 is refused: the
// pre-watermark inputs a late joiner would need are already discarded —
// the journal is the late-join/catch-up story).
int64_t ggrs_bank_attach_spectator(void* ptr, int64_t session, uint16_t magic,
                                   int64_t now_ms) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size()) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  // refuse late joins: the cursor must still be able to start at frame 0.
  // next_spectator_frame alone is not enough — a slot that never had a
  // spectator or journal keeps it at 0 while the watermark discard (and
  // the input ring's wraparound) eat the early frames; admitting such an
  // attach would fault the whole slot on its next tick.
  if (s->next_spectator_frame > 0 || s->current_frame > 0 ||
      s->last_confirmed > 0) {
    return kBankErrSpecStream;
  }
  // the spectator count crosses the tick/harvest/stats layouts as a u8;
  // the 256th attach would silently misalign every parse
  if (s->spectators.size() >= 255) return kBankErrSpecStream;
  Writer send_base, recv_base;
  std::vector<uint8_t> zeros(static_cast<size_t>(s->input_size), 0);
  for (int i = 0; i < s->num_players; ++i) {
    send_base.uvarint(static_cast<uint64_t>(s->input_size));
    send_base.raw(zeros.data(), zeros.size());
  }
  // viewers never send inputs; a single default entry keeps the recv side
  // well-formed and any stray InputMessage from a viewer drops harmlessly
  recv_base.uvarint(static_cast<uint64_t>(s->input_size));
  recv_base.raw(zeros.data(), zeros.size());
  void* ep = ggrs_ep_new(send_base.buf.data(), send_base.buf.size(),
                         recv_base.buf.data(), recv_base.buf.size(),
                         s->max_prediction);
  if (!ep) return kBankErrCmd;
  s->spectators.emplace_back();
  BankEndpoint& e = s->spectators.back();
  e.ep = ep;
  e.magic = magic;
  e.last_send = e.last_recv = e.last_input_recv = e.last_quality = now_ms;
  e.stats_start = now_ms;
  e.peer_disc.assign(s->num_players, 0);
  e.peer_last.assign(s->num_players, kNullFrame);
  return static_cast<int64_t>(s->spectators.size()) - 1;
}

// Detach: immediate shutdown (no 5 s linger — the hub already decided).
// The slot stays in the table so other spectator indices remain stable.
int ggrs_bank_detach_spectator(void* ptr, int64_t session, int64_t spec) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size()) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  if (spec < 0 || static_cast<size_t>(spec) >= s->spectators.size()) {
    return kBankErrCmd;
  }
  BankEndpoint& sp = s->spectators[static_cast<size_t>(spec)];
  sp.state = kShutdown;
  s->dirty = true;
  // drop the batched-I/O deferral too: the shuttle clears sp.deferred on
  // detach, and a stale tick of fan-out must not chase a departed viewer
  sp.deferred.clear();
  return kBankOk;
}

// Journal tap: when enabled, every newly-confirmed frame's inputs are
// staged into the session's tick-output record (the n_conf section) from
// the SAME crossing that fans them out — journaling costs zero extra
// crossings at steady state.
int ggrs_bank_set_confirmed_stream(void* ptr, int64_t session, int enabled) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size()) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  if (enabled && s->next_spectator_frame == 0 &&
      (s->current_frame > 0 || s->last_confirmed > 0)) {
    // same late-join rule as attach: a journal must start at frame 0 (or
    // ride an already-running fan-out cursor); frames below the watermark
    // are gone and the tap would fault the slot
    return kBankErrSpecStream;
  }
  s->stream_confirmed = enabled != 0;
  return kBankOk;
}

// Arm/disarm the in-crossing phase timers (DESIGN.md §14).  When armed,
// every ggrs_bank_tick appends a per-tick timing tail to its output and
// ggrs_bank_stats appends the cumulative totals — tracing rides the
// existing crossings.  When disarmed (the default) the tick performs zero
// clock reads and emits byte-identical output to a pre-timing build.
int ggrs_bank_set_timing(void* ptr, int enabled) {
  static_cast<Bank*>(ptr)->timing = enabled != 0;
  return kBankOk;
}

// THE crossing.  Command stream, little-endian, per session in order:
//   u8 flags (bit0 = local inputs present -> advance phase runs;
//             bit1 = skip: slot is quarantined/evicted, NO further fields
//             follow for this session;
//             bit2 = staged: inputs were staged natively via
//             ggrs_bank_stage_inputs, NO inline input bytes follow)
//   [flags&1 && !flags&4] n_local * input_size raw input bytes
//             (sorted-handle order)
//   u16 n_ctrl;  per ctrl: u8 op, u16 ep, i64 frame
//     op 1 = disconnect endpoint at `frame`
//     op 2 = inject a simulated per-slot fault (`frame` carries the error
//            code; the chaos harness's native-fault stand-in)
//     op 3 = disconnect spectator `ep` (hub policy, applied next tick)
//   u16 n_datagrams;  per datagram: u16 ep, u32 len, bytes
//   u16 n_spec_datagrams;  per datagram: u16 spectator, u32 len, bytes
// Output stream: FIRST a packed header table (DESIGN.md §19) — per session,
// kHdrStride (48) bytes:
//   u32 flags (kHdr* bits: live/quiet/events/spec/consensus/dirty/out/
//              skip/conf), u32 rec_len (byte length of this session's body
//              record), i32 err, i32 frames_ahead, i64 landed_frame,
//              i64 current_frame, i64 last_confirmed, i64 save_frame (the
//              quiet tick's save op frame, kNullFrame otherwise)
// — then the request descriptor table (§21) — per session, kReqStride (24)
// bytes (see the kReq* block above): the tick's request program as flat
// data, so the pool and the device executor never parse op bytes for
// quiet/resim/save-only slots
// — then the body records, per session in order:
//   i32 err  (0 = ok; negative kBankErr* = THIS SLOT faulted this tick —
//             its ops/outbound/events are suppressed, only the status
//             mirrors below are live; the rest of the bank is unaffected)
//   i64 landed_frame
//   i32 frames_ahead (max time-sync average over connected endpoints)
//   i64 current_frame (post-tick), i64 last_confirmed
//   u8 consensus_pending
//   u16 n_ops;  per op: u8 kind (0 save / 1 load / 2 advance);
//     save/load: i64 frame;  advance: players * u8 status,
//     players * input_size input bytes
//   u16 n_out_poll;  per datagram: u16 ep, u32 len, bytes  [poll phase]
//   u16 n_out_adv;   per datagram: u16 ep, u32 len, bytes  [input sends]
//   u16 n_events;  per event: u8 kind, u16 ep, kind-specific payload
//   u8 n_endpoints;  per endpoint: u8 state, num_players * (u8 disc, i64 lf)
//   num_players * (u8 disc, i64 last_frame)   [local status mirror]
//   --- broadcast tail (emit_spectator_tail) ---
//   i64 next_spectator_frame
//   u8 n_spectators;  per: u8 state, i64 last_acked_frame
//   u16 n_spec_out;  per: u16 spectator, u8 phase (0 poll / 1 fan-out),
//     u32 len, bytes  — phase-1 datagrams are sent by the pool one tick
//     later, reproducing the Python session's flush order exactly
//   u16 n_spec_events;  per: u8 kind, u16 spectator [+ i64 for interrupted]
//   u16 n_conf;  [if > 0] i64 conf_start; per frame:
//     players * u8 blank_flag, players * input_size bytes  [journal tap]
// After the last session record, ONLY when ggrs_bank_set_timing armed the
// phase timers (DESIGN.md §14):
//   kNumPhases * u64 phase_ns, u8 n_phases   [timing tail; count byte
//     last so the caller parses it from the END of the buffer]
// Returns 0, kErrBufferTooSmall (retry with a bigger out), or kBankErrCmd
// (malformed command stream — the one remaining whole-bank failure).
//
// `io` (ggrs_bank_pump): slots with an attached NetBatch additionally
// drain their socket via recvmmsg at the top of the slot step (routed by
// the address tables; the cmd's datagram sections then carry only
// injected traffic) and flush their outbound + fan-out streams via
// sendmmsg at the bottom — same wire bytes, same send order, with the
// outbound sections of the output record emitted empty.  A fatal socket
// error is a PER-SLOT fault (kBankErrIo), exactly the blast radius a
// raising socket.sendto has on the shuttle path.  Slots without an
// attached socket behave identically under both entry points.
static int bank_tick_impl(Bank* bank, int64_t now, const uint8_t* cmd,
                          size_t cmd_len, uint8_t* out, size_t out_cap,
                          size_t* out_len, bool io) {
  CmdReader r{cmd, cmd_len};
  bank->out.clear();
  // packed per-tick header (DESIGN.md §19) + request descriptor table
  // (§21): one kHdrStride record per session, then one kReqStride record
  // per session, both patched as each body record closes.  The two tables
  // lead the output so the pool can classify all B slots AND build the
  // device dispatch (NumPy over the tables) before touching body bytes.
  bank->out.resize(bank->sessions.size() * (kHdrStride + kReqStride), 0);
  size_t hdr_off = 0;
  size_t req_off = bank->sessions.size() * kHdrStride;
  std::vector<uint8_t> ops;
  std::vector<EpEvent> staged_events;
  std::vector<int32_t> staged_eps;
  PhaseTimer pt;
  pt.on = bank->timing;
  const uint64_t tick_t0 = pt.on ? mono_ns() : 0;

  if (io) {
    // PRE-DRAIN every attached, non-skipped slot before ANY slot steps or
    // flushes — the shuttle drains all sockets before its single crossing,
    // so when one pool hosts both sides of a match, slot j must see slot
    // i's tick-T datagrams at tick T+1, not mid-crossing at tick T.  The
    // scan walks the cmd structure only to find each slot's skip flag
    // (skipped slots' sockets belong to their evicted sessions); the
    // drained lists stay on each NetBatch until routed in the slot step.
    pt.skip();  // pre-drain kernel I/O is inbound time (the §14 contract:
    // the inbound phase CONTAINS the receive-side syscalls)
    CmdReader scan{cmd, cmd_len};
    for (BankSession* s : bank->sessions) {
      uint8_t flags = scan.u8();
      if (!scan.ok) return kBankErrCmd;
      if (flags & kFlagSkip) continue;
      if ((flags & kFlagInputs) && !(flags & kFlagStaged)) {
        scan.raw(s->local_handles.size() *
                 static_cast<size_t>(s->input_size));
      }
      uint16_t n_ctrl = scan.u16();
      for (uint16_t i = 0; i < n_ctrl; ++i) {
        scan.u8();
        scan.u16();
        scan.i64();
      }
      for (int section = 0; section < 2; ++section) {
        uint16_t nd = scan.u16();
        for (uint16_t i = 0; i < nd; ++i) {
          scan.u16();
          scan.raw(scan.u32());
        }
      }
      if (!scan.ok) return kBankErrCmd;
      if (s->net) {
        int n_rx = ggrs_net_recv_all(s->net);
        if (n_rx < 0) s->pending_io_err = kBankErrIo;
      }
    }
    pt.lap(kPhInbound);
  }

  for (BankSession* s : bank->sessions) {
    uint8_t flags = r.u8();
    if (!r.ok) return kBankErrCmd;
    std::vector<uint8_t>* o = &bank->out;
    const size_t rec_start = o->size();
    const size_t my_hdr = hdr_off;
    hdr_off += kHdrStride;
    const size_t my_req = req_off;
    req_off += kReqStride;
    if (flags & kFlagSkip) {
      // quarantined/evicted slot: nothing runs, emit a status-only record
      // so the output stream stays positionally aligned.  The stale
      // fan-out deferral is dropped, like the shuttle's sp.deferred on a
      // non-live tick (eviction re-sends from the harvested window);
      // the socket is NOT drained — the evicted session owns it now.
      for (BankEndpoint& sp : s->spectators) sp.deferred.clear();
      put_u32(o, 0);  // err = 0 (the fault was reported when it happened)
      put_i64(o, kNullFrame);
      put_u32(o, 0);
      put_i64(o, s->current_frame);
      put_i64(o, s->last_confirmed);
      put_u8(o, 0);
      put_u16(o, 0);  // n_ops
      put_u16(o, 0);  // n_out_poll
      put_u16(o, 0);  // n_out_adv
      put_u16(o, 0);  // n_events
      emit_status_mirrors(o, s);
      emit_spectator_tail(o, s, false);
      uint32_t hflags = kHdrSkip;
      if (s->dirty) hflags |= kHdrDirty;
      if (!s->spectators.empty()) hflags |= kHdrSpec;
      hdr_patch(o, my_hdr, hflags,
                static_cast<uint32_t>(o->size() - rec_start), 0, 0,
                kNullFrame, s->current_frame, s->last_confirmed, kNullFrame);
      req_patch(o, my_req, ReqDesc{});  // kReqEmpty
      s->dirty = false;
      continue;
    }
    int err = kBankOk;  // per-SLOT fault accumulator; never fails the tick
    const uint8_t* local_inputs = nullptr;
    if (flags & kFlagStaged) {
      // batched staging (§21): the inputs were staged natively; the flag
      // byte carries no inline bytes.  An incomplete staging set is a
      // BUILDER bug (the Python driver validates completeness before the
      // crossing), so it is the whole-bank cmd error, not a slot fault.
      if (!(flags & kFlagInputs) ||
          s->staged_count != static_cast<int>(s->local_handles.size())) {
        return kBankErrCmd;
      }
      local_inputs = s->staged_local.data();
    } else {
      if (s->staged_count) {
        // the cmd chose the inline path this tick: any native staging is
        // stale by definition and must not survive into a later tick
        std::fill(s->staged_mask.begin(), s->staged_mask.end(), 0);
        s->staged_count = 0;
      }
      if (flags & kFlagInputs) {
        local_inputs = r.raw(s->local_handles.size() *
                             static_cast<size_t>(s->input_size));
      }
    }
    uint16_t n_ctrl = r.u16();
    if (!r.ok) return kBankErrCmd;
    for (BankEndpoint& ep : s->endpoints) {
      ep.out_poll.clear();
      ep.out_adv.clear();
      ep.cur_out = &ep.out_poll;
      ep.out_count = 0;
      ep.evin_bytes.clear();
    }
    for (BankEndpoint& ep : s->spectators) {
      ep.out_poll.clear();
      ep.out_adv.clear();
      ep.cur_out = &ep.out_poll;
      ep.out_count = 0;
      ep.evin_bytes.clear();
    }
    s->conf_stream.clear();
    s->conf_count = 0;
    s->conf_start = kNullFrame;
    for (uint16_t i = 0; i < n_ctrl; ++i) {
      uint8_t op = r.u8();
      uint16_t ep_idx = r.u16();
      int64_t frame = r.i64();
      if (!r.ok) return kBankErrCmd;
      if (op == 1 && ep_idx < s->endpoints.size()) {
        disconnect_endpoint(s, &s->endpoints[ep_idx], now, frame);
      } else if (op == 2) {
        // simulated native slot fault: the whole slot tick is skipped, as
        // a real mid-tick fault would leave it
        err = frame < 0 ? static_cast<int>(frame) : kBankErrInjected;
      } else if (op == 3 && ep_idx < s->spectators.size()) {
        // disconnect spectator (hub policy, one tick after its event —
        // p2p.py's spectator branch of _disconnect_player_at_frame: no
        // local-status or rollback side effects, just the endpoint)
        BankEndpoint& sp = s->spectators[ep_idx];
        if (sp.state != kShutdown) {
          sp.state = kDisconnected;
          sp.shutdown_at = now + kShutdownTimerMs;
          s->dirty = true;
        }
      }
    }

    // ---- poll phase (p2p.py poll_remote_clients) ----
    pt.skip();
    const bool io_slot = io && s->net != nullptr;
    int n_rx = 0;
    if (io_slot) {
      // the socket was already drained by the pre-pass above (before any
      // slot could flush into it); route the retained list here.  A fatal
      // receive errno is this slot's fault, nobody else's — and even a
      // slot faulted by an earlier ctrl op was drained (the shuttle
      // drains before the crossing too); only the PROCESSING is gated.
      if (s->pending_io_err != kBankOk) {
        if (err == kBankOk) err = s->pending_io_err;
        s->pending_io_err = kBankOk;
      }
      n_rx = ggrs_net_recv_count(s->net);
      // pass 1: remote-endpoint datagrams in arrival order — the shuttle
      // builds its cmd section the same way (socket drain first, injected
      // datagrams appended after)
      for (int i = 0; err == kBankOk && i < n_rx; ++i) {
        uint32_t ip, dlen;
        uint16_t port;
        const uint8_t* data;
        if (ggrs_net_datagram(s->net, i, &ip, &port, &data, &dlen) != kNetOk) {
          break;
        }
        uint64_t key = addr_key(ip, port);
        for (size_t e = 0; e < s->endpoints.size(); ++e) {
          if (key_at(s->ep_keys, e) == key) {
            process_datagram(bank, s, &s->endpoints[e], now, data, dlen);
            break;
          }
        }
      }
    }
    uint16_t n_datagrams = r.u16();
    if (!r.ok) return kBankErrCmd;
    for (uint16_t i = 0; i < n_datagrams; ++i) {
      uint16_t ep_idx = r.u16();
      uint32_t dlen = r.u32();
      const uint8_t* data = r.raw(dlen);
      if (!r.ok) return kBankErrCmd;  // parse ALL datagrams: stream alignment
      if (err == kBankOk && ep_idx < s->endpoints.size()) {
        process_datagram(bank, s, &s->endpoints[ep_idx], now, data, dlen);
      }
    }
    if (io_slot) {
      // pass 2: spectator datagrams (the shuttle's separate spec section —
      // all remote traffic processes before any viewer traffic).  A
      // datagram from an unknown address routes nowhere and drops, like
      // the shuttle's addr_to_ep/addr_to_spec misses.  Remote addresses
      // are EXCLUDED, mirroring the shuttle's if/elif routing: a key that
      // matched pass 1 must not feed a second endpoint.
      for (int i = 0; err == kBankOk && i < n_rx; ++i) {
        uint32_t ip, dlen;
        uint16_t port;
        const uint8_t* data;
        if (ggrs_net_datagram(s->net, i, &ip, &port, &data, &dlen) != kNetOk) {
          break;
        }
        uint64_t key = addr_key(ip, port);
        bool is_remote = false;
        for (size_t e = 0; e < s->endpoints.size(); ++e) {
          if (key_at(s->ep_keys, e) == key) {
            is_remote = true;
            break;
          }
        }
        if (is_remote) continue;
        for (size_t e = 0; e < s->spectators.size(); ++e) {
          if (key_at(s->spec_keys, e) == key) {
            process_datagram(bank, s, &s->spectators[e], now, data, dlen);
            break;
          }
        }
      }
    }
    // inbound spectator traffic (acks, quality reports, keep-alives, sync
    // requests) — routed by the hub's address table, same crossing
    uint16_t n_spec_dgrams = r.u16();
    if (!r.ok) return kBankErrCmd;
    for (uint16_t i = 0; i < n_spec_dgrams; ++i) {
      uint16_t sp_idx = r.u16();
      uint32_t dlen = r.u32();
      const uint8_t* data = r.raw(dlen);
      if (!r.ok) return kBankErrCmd;
      if (err == kBankOk && sp_idx < s->spectators.size()) {
        process_datagram(bank, s, &s->spectators[sp_idx], now, data, dlen);
      }
    }
    pt.lap(kPhInbound);
    std::vector<uint8_t> out_events;
    uint16_t n_out_events = 0;
    std::vector<uint8_t> spec_events;
    uint16_t n_spec_events = 0;
    int64_t landed = kNullFrame;
    int64_t frames_ahead = 0;
    bool pending_consensus = false;
    ops.clear();
    uint16_t n_ops = 0;
    if (err == kBankOk) {
      for (BankEndpoint& ep : s->endpoints) {
        // update_local_frame_advantage (current_frame is never NULL)
        if (ep.state == kRunning) {
          int64_t last_recv_frame = ggrs_ep_last_recv_frame(ep.ep);
          if (last_recv_frame != kNullFrame) {
            int64_t ping = ep.rtt / 2;
            int64_t remote_frame = last_recv_frame + (ping * s->fps) / 1000;
            ep.local_adv = remote_frame - s->current_frame;
          }
        }
      }
      // stage events before handling (the poll loop), then apply in endpoint
      // order — identical to p2p.py's two-pass event handling
      staged_events.clear();
      staged_eps.clear();
      for (size_t e = 0; e < s->endpoints.size(); ++e) {
        BankEndpoint& ep = s->endpoints[e];
        poll_timers(bank, s, &ep, now);
        while (!ep.events.empty()) {
          staged_events.push_back(ep.events.front());
          staged_eps.push_back(static_cast<int32_t>(e));
          ep.events.pop_front();
        }
      }
      // spectator timers run after the remotes' (p2p.py polls
      // _all_endpoints in remotes-then-spectators order); their events go
      // to the HUB stream — never into the session's input/event path (a
      // viewer's lifecycle is hub policy, and a malicious viewer's
      // InputMessage must not reach the sync layer)
      for (size_t e = 0; e < s->spectators.size(); ++e) {
        BankEndpoint& sp = s->spectators[e];
        poll_timers(bank, s, &sp, now);
        while (!sp.events.empty()) {
          const EpEvent& ev = sp.events.front();
          if (ev.kind != kEvInput) {
            put_u8(&spec_events, ev.kind);
            put_u16(&spec_events, static_cast<uint16_t>(e));
            if (ev.kind == kEvInterrupted) put_i64(&spec_events, ev.a);
            ++n_spec_events;
          }
          sp.events.pop_front();
        }
      }
      pt.lap(kPhTimers);
      for (size_t i = 0; err == kBankOk && i < staged_events.size(); ++i) {
        const EpEvent& ev = staged_events[i];
        BankEndpoint& ep = s->endpoints[static_cast<size_t>(staged_eps[i])];
        if (ev.kind == kEvInput) {
          // p2p.py _handle_event EvInput: sequence invariant, status update,
          // remote enqueue — skipped entirely for disconnected players
          int32_t h = ev.handle;
          if (!s->local_disc[h]) {
            int64_t cur = s->local_last[h];
            if (!(cur == kNullFrame || cur + 1 == ev.a)) {
              err = kBankErrSequence;  // slot fault, not a pool kill
              break;
            }
            s->local_last[h] = ev.a;
            int64_t rc = ggrs_sync_add_input(s->sync, h, ev.a,
                                             ep.evin_bytes.data() + ev.off);
            if (rc < kNullFrame) {
              err = kBankErrSync;
              break;
            }
          }
        } else {
          put_u8(&out_events, ev.kind);
          put_u16(&out_events, static_cast<uint16_t>(staged_eps[i]));
          if (ev.kind == kEvInterrupted) put_i64(&out_events, ev.a);
          if (ev.kind == kEvChecksum) {
            put_i64(&out_events, ev.a);
            put_u64(&out_events, ev.lo);
            put_u64(&out_events, ev.hi);
          }
          ++n_out_events;
        }
      }
      pt.lap(kPhCommit);
    }

    // ---- advance phase (p2p.py advance_frame after its poll) ----
    if (err == kBankOk) {
      pending_consensus = consensus_pending(s);
      for (BankEndpoint& ep : s->endpoints) ep.cur_out = &ep.out_adv;
      for (BankEndpoint& ep : s->spectators) ep.cur_out = &ep.out_adv;
      if (flags & kFlagInputs) {
        if (!local_inputs) return kBankErrCmd;
        int rc = advance_session(bank, s, now, local_inputs, &ops, &n_ops,
                                 &landed, &frames_ahead, &pt);
        if (rc != kBankOk) err = rc;
      } else {
        frames_ahead = max_frame_advantage(s);
      }
    }
    // ---- batched socket outbound (attached slots): stage + one flush ----
    // Runs only when the tick produced a clean slot (a faulted slot's
    // streams are suppressed below, exactly like the shuttle's empty
    // outbound sections); a fatal flush errno faults the slot AFTER the
    // datagrams that did go out — the same partial-send window a raising
    // socket.sendto leaves on the Python path.
    if (io_slot && err == kBankOk) {
      pt.skip();
      int rc = stage_and_flush_io(s);
      if (rc != kBankOk) err = rc;
      pt.lap(kPhOutbound);
    }
    s->stat_ticks += 1;
    if (err != kBankOk) {
      s->stat_faults += 1;
      // faulted slot: suppress everything this tick produced — partial ops
      // would desync the game, partial sends would confuse the peer.  The
      // status mirrors stay live (the harvest and eviction read them).
      ops.clear();
      n_ops = 0;
      out_events.clear();
      n_out_events = 0;
      spec_events.clear();
      n_spec_events = 0;
      landed = kNullFrame;
      frames_ahead = 0;
      pending_consensus = false;
      for (BankEndpoint& ep : s->endpoints) {
        ep.out_poll.clear();
        ep.out_adv.clear();
        ep.out_count = 0;
      }
      for (BankEndpoint& ep : s->spectators) {
        ep.out_poll.clear();
        ep.out_adv.clear();
        ep.out_count = 0;
        // the deferral is stale the moment the slot faults (the shuttle
        // clears sp.deferred on every non-live tick); eviction re-sends
        // the fan-out window from the harvest
        ep.deferred.clear();
      }
      s->conf_stream.clear();
      s->conf_count = 0;
      s->conf_start = kNullFrame;
    }

    // ---- session output record ----
    pt.skip();
    put_u32(o, static_cast<uint32_t>(err));
    put_i64(o, landed);
    put_u32(o, static_cast<uint32_t>(static_cast<int32_t>(frames_ahead)));
    put_i64(o, s->current_frame);
    put_i64(o, s->last_confirmed);
    put_u8(o, pending_consensus ? 1 : 0);
    put_u16(o, n_ops);
    put_raw(o, ops.data(), ops.size());
    // the two phases are SEPARATE sections (each in endpoint order): the
    // Python session's per-socket send order interleaves the spectator
    // queues between them (poll's send_all_messages flushes remotes then
    // spectators, then advance sends the remote input messages), so the
    // pool needs the phase boundary to reproduce that order exactly.
    // Attached-socket slots already sent everything through the NetBatch:
    // their sections are empty and the packet path never re-enters Python.
    bool any_out = false;
    if (io_slot) {
      put_u16(o, 0);  // n_out_poll
      put_u16(o, 0);  // n_out_adv
    } else {
      for (const BankEndpoint& ep : s->endpoints) {
        if (!ep.out_poll.empty() || !ep.out_adv.empty()) {
          any_out = true;
          break;
        }
      }
      emit_out_section(o, s->endpoints, 0);
      emit_out_section(o, s->endpoints, 1);
    }
    put_u16(o, n_out_events);
    put_raw(o, out_events.data(), out_events.size());
    emit_status_mirrors(o, s);
    emit_spectator_tail(o, s, true, &spec_events, n_spec_events, io_slot);
    // ---- header classification (the pool's fast-path contract) ----
    // QUIET = the ops are exactly [save(frame), advance]: the shape every
    // healthy in-window tick produces.  The save frame rides the header so
    // the fast path never reads the op bytes for it; the advance op's
    // statuses/blob sit at a fixed offset (35 + 9 + 1) inside the record.
    int64_t save_frame = kNullFrame;
    bool quiet = false;
    if (err == kBankOk && n_ops == 2 && ops.size() > 10 && ops[0] == 0 &&
        ops[9] == 2 &&
        ops.size() == 10 + static_cast<size_t>(s->num_players) *
                               (1 + static_cast<size_t>(s->input_size))) {
      quiet = true;
      uint64_t u = 0;
      for (int i = 0; i < 8; ++i) {
        u |= static_cast<uint64_t>(ops[1 + i]) << (8 * i);
      }
      save_frame = static_cast<int64_t>(u);
    }
    uint32_t hflags = 0;
    if (err == kBankOk) hflags |= kHdrLive;
    if (quiet) hflags |= kHdrQuiet;
    if (n_out_events) hflags |= kHdrEvents;
    if (!s->spectators.empty() || n_spec_events) hflags |= kHdrSpec;
    if (pending_consensus) hflags |= kHdrConsensus;
    if (s->dirty) hflags |= kHdrDirty;
    if (any_out) hflags |= kHdrOut;
    if (s->conf_count) hflags |= kHdrConf;
    hdr_patch(o, my_hdr, hflags,
              static_cast<uint32_t>(o->size() - rec_start),
              static_cast<int32_t>(err), static_cast<int32_t>(frames_ahead),
              landed, s->current_frame, s->last_confirmed, save_frame);
    // request descriptor (§21): classified from the ops the record carries
    // (a faulted slot's ops were cleared above, so it classifies kReqEmpty)
    ReqDesc rd = classify_ops(ops, n_ops, s->num_players, s->input_size);
    req_patch(o, my_req, rd);
    if ((flags & kFlagStaged) && err == kBankOk &&
        (rd.rflags & kReqFlagTrailingAdv)) {
      // the tick's trailing advance consumed the staged inputs — the
      // native twin of the reference decoder's `if advanced:
      // staged_inputs.clear()`.  A faulted or prediction-limited tick
      // keeps them (eviction re-feeds; the caller re-stages next tick).
      std::fill(s->staged_mask.begin(), s->staged_mask.end(), 0);
      s->staged_count = 0;
    }
    s->dirty = false;
    pt.lap(kPhEmit);
  }

  if (r.pos != r.len) return kBankErrCmd;  // trailing garbage: refuse
  if (pt.on) {
    // timing tail (count byte LAST so Python can parse from the end
    // without knowing the phase count up front): kNumPhases u64 ns then
    // u8 kNumPhases.  "other" closes the books: phases sum exactly to the
    // measured in-crossing time.
    uint64_t total = mono_ns() - tick_t0;
    uint64_t sum = 0;
    for (int i = 0; i < kPhOther; ++i) sum += pt.ns[i];
    pt.ns[kPhOther] = total > sum ? total - sum : 0;
    // staging happened OUTSIDE this tick's window (ggrs_bank_stage_inputs
    // crossings since the last tick); it rides the tail as its own entry
    // and is never part of the in-crossing sum the `other` phase closes
    pt.ns[kPhStaging] = bank->staging_pending;
    bank->staging_pending = 0;
    bank->timed_ticks += 1;
    for (int i = 0; i < kNumPhases; ++i) {
      bank->phase_total[i] += pt.ns[i];
      put_u64(&bank->out, pt.ns[i]);
    }
    put_u8(&bank->out, static_cast<uint8_t>(kNumPhases));
  }
  if (bank->out.size() > out_cap) {
    // the tick already ran and its full output is retained in bank->out:
    // report the needed size so the caller can grow its buffer and fetch
    // via ggrs_bank_fetch_out — an extra crossing only on the rare growth
    // tick (e.g. a stalled peer's whole-window retransmit volley), never a
    // poisoned pool
    *out_len = bank->out.size();
    return kErrBufferTooSmall;
  }
  std::memcpy(out, bank->out.data(), bank->out.size());
  *out_len = bank->out.size();
  return kBankOk;
}

int ggrs_bank_tick(void* ptr, int64_t now, const uint8_t* cmd, size_t cmd_len,
                   uint8_t* out, size_t out_cap, size_t* out_len) {
  return bank_tick_impl(static_cast<Bank*>(ptr), now, cmd, cmd_len, out,
                        out_cap, out_len, false);
}

// The crossing of the batched datapath (DESIGN.md §15): ggrs_bank_tick
// plus native socket I/O for every slot with an attached NetBatch —
// datagrams flow socket → crossing → socket with zero Python on the
// packet path.  Same command/output wire format; still exactly ONE
// crossing per pool tick.
int ggrs_bank_pump(void* ptr, int64_t now, const uint8_t* cmd, size_t cmd_len,
                   uint8_t* out, size_t out_cap, size_t* out_len) {
  return bank_tick_impl(static_cast<Bank*>(ptr), now, cmd, cmd_len, out,
                        out_cap, out_len, true);
}

// Attach a net_batch.cpp NetBatch (borrowed, never freed here) to one
// slot: ggrs_bank_pump then drains/flushes this slot's datagrams natively.
// The pool must map every remote/spectator address via ggrs_bank_map_addr
// before the first pump.
int ggrs_bank_attach_socket(void* ptr, int64_t session, void* net) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size() || !net) {
    return kBankErrCmd;
  }
  bank->sessions[static_cast<size_t>(session)]->net = net;
  return kBankOk;
}

// Detach: the slot returns to the Python shuttle on the next tick (the
// pool's per-slot automatic fallback, e.g. an unresolvable late-attached
// spectator address).  Routing tables are kept — re-attach is cheap.
int ggrs_bank_detach_socket(void* ptr, int64_t session) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size()) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  s->net = nullptr;
  for (BankEndpoint& sp : s->spectators) sp.deferred.clear();
  return kBankOk;
}

// Register the wire address of one endpoint (kind 0 = remote, 1 =
// spectator) for the native inbound routing and outbound staging.  `ip`
// is sin_addr.s_addr as stored (the bytes of inet_aton), `port` is
// host-order.
int ggrs_bank_map_addr(void* ptr, int64_t session, int kind, int64_t idx,
                       uint32_t ip, uint16_t port) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 ||
      static_cast<size_t>(session) >= bank->sessions.size() || idx < 0 ||
      idx > 0xFFFF || (kind != 0 && kind != 1)) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  std::vector<uint64_t>& keys = kind == 0 ? s->ep_keys : s->spec_keys;
  if (keys.size() <= static_cast<size_t>(idx)) {
    keys.resize(static_cast<size_t>(idx) + 1, kNoAddr);
  }
  keys[static_cast<size_t>(idx)] = addr_key(ip, port);
  return kBankOk;
}

// Fetch the retained output of the last ggrs_bank_tick (the recovery path
// for kErrBufferTooSmall; valid until the next tick).
int ggrs_bank_fetch_out(void* ptr, uint8_t* out, size_t out_cap,
                        size_t* out_len) {
  Bank* bank = static_cast<Bank*>(ptr);
  *out_len = bank->out.size();
  if (bank->out.size() > out_cap) return kErrBufferTooSmall;
  std::memcpy(out, bank->out.data(), bank->out.size());
  return kBankOk;
}

int64_t ggrs_bank_session_count(void* ptr) {
  return static_cast<int64_t>(static_cast<Bank*>(ptr)->sessions.size());
}

// Presence/version probe for the packed per-tick output header (DESIGN.md
// §19): a library exporting this symbol (a) leads every tick output with
// one kHdrStride-byte record per session and (b) extends each harvest
// endpoint record with the peer status mirrors.  Returns the stride.
int ggrs_bank_hdr_stride(void) { return static_cast<int>(kHdrStride); }

// Presence/version probes for the descriptor plane (DESIGN.md §21): a
// library exporting these (a) accepts batched input staging via
// ggrs_bank_stage_inputs + the kFlagStaged cmd flag, (b) emits the per-slot
// request descriptor table between the header table and the body records,
// and (c) appends the staged-inputs tail to every harvest.  A stride that
// does not match the Python driver's dtype is layout skew — the pool falls
// back to per-session Python sessions, like a header-stride mismatch.
int ggrs_bank_req_stride(void) { return static_cast<int>(kReqStride); }
int ggrs_bank_stage_stride(void) { return static_cast<int>(kStageStride); }

// Batched input staging (descriptor plane, §21): stage MANY slots' local
// inputs in ONE crossing.  `desc` is n records of kStageStride bytes
// (u32 slot, i32 handle, i64 frame, u32 off, u32 len) whose off/len jump
// into `payload`; `frame` is reserved for delayed/variable staging and
// must be kNullFrame today.  Every record's len must equal its slot's
// input_size (the variable-size seam is the len field itself).  Staging
// the same (slot, handle) twice re-stages (last write wins).  Returns the
// number of records staged, or kBankErrCmd on any malformed record —
// nothing is partially visible on error except records already staged
// (the Python driver validates first, so a failure here is a builder bug).
int64_t ggrs_bank_stage_inputs(void* ptr, const uint8_t* desc, int64_t n,
                               const uint8_t* payload, size_t payload_len) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (n < 0 || (n > 0 && (!desc || !payload))) return kBankErrCmd;
  const uint64_t t0 = bank->timing ? mono_ns() : 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = desc + static_cast<size_t>(i) * kStageStride;
    auto r32 = [&p](size_t at) {
      uint32_t v = 0;
      for (int k = 0; k < 4; ++k) {
        v |= static_cast<uint32_t>(p[at + k]) << (8 * k);
      }
      return v;
    };
    uint32_t slot = r32(0);
    int32_t handle = static_cast<int32_t>(r32(4));
    uint64_t fu = 0;
    for (int k = 0; k < 8; ++k) {
      fu |= static_cast<uint64_t>(p[8 + k]) << (8 * k);
    }
    int64_t frame = static_cast<int64_t>(fu);
    uint32_t off = r32(16);
    uint32_t len = r32(20);
    if (slot >= bank->sessions.size()) return kBankErrCmd;
    BankSession* s = bank->sessions[slot];
    if (frame != kNullFrame) return kBankErrCmd;  // reserved
    if (len != static_cast<uint32_t>(s->input_size)) return kBankErrCmd;
    if (static_cast<size_t>(off) + len > payload_len) return kBankErrCmd;
    size_t j = 0;
    for (; j < s->local_handles.size(); ++j) {
      if (s->local_handles[j] == handle) break;
    }
    if (j == s->local_handles.size()) return kBankErrCmd;  // not local
    if (!s->staged_mask[j]) {
      s->staged_mask[j] = 1;
      s->staged_count += 1;
    }
    std::memcpy(s->staged_local.data() +
                    j * static_cast<size_t>(s->input_size),
                payload + off, len);
  }
  if (bank->timing) bank->staging_pending += mono_ns() - t0;
  return n;
}

// Harvest one session's resumable state for Python-fallback eviction — the
// read-only dump host_bank.py turns into a mid-stream P2PSession via the
// adoption seam (P2PSession.adopt_resume_state).  Little-endian layout:
//   i64 current_frame, i64 last_confirmed, i64 disconnect_frame
//   u8 num_players, u32 input_size            [sanity echo]
//   per player:
//     u8 disc, i64 local_last
//     i64 inputs_start (kNullFrame if none), u32 count,
//     count * input_size input bytes          [frames start..start+count)
//   u8 n_endpoints; per endpoint:
//     u8 state
//     num_players * (u8 peer_disc, i64 peer_last)   [peer status mirror —
//       authoritative for eviction/export: the vectorized pool's Python
//       mirrors may be quiet-tick stale]
//     send dump  (ggrs_ep_dump_send: last_acked_frame, base, pending window)
//     recv dump  (ggrs_ep_dump_recv: last_recv_frame, ring window)
//   i64 next_spectator_frame
//   u8 n_spectators; per spectator:
//     u8 state
//     send dump  (the fan-out window a relaying eviction must resume with;
//     viewers have no recv state worth harvesting)
// Returns 0, kErrBufferTooSmall (*out_len = needed), or kBankErrCmd for a
// bad session index.  Read-only: safe to retry, never perturbs the bank.
int ggrs_bank_harvest(void* ptr, int64_t session, uint8_t* out, size_t cap,
                      size_t* out_len) {
  Bank* bank = static_cast<Bank*>(ptr);
  if (session < 0 || static_cast<size_t>(session) >= bank->sessions.size()) {
    return kBankErrCmd;
  }
  BankSession* s = bank->sessions[static_cast<size_t>(session)];
  std::vector<uint8_t> h;
  put_i64(&h, s->current_frame);
  put_i64(&h, s->last_confirmed);
  put_i64(&h, s->disconnect_frame);
  put_u8(&h, static_cast<uint8_t>(s->num_players));
  put_u32(&h, static_cast<uint32_t>(s->input_size));
  std::vector<uint8_t> input_buf(static_cast<size_t>(s->input_size));
  for (int p = 0; p < s->num_players; ++p) {
    put_u8(&h, s->local_disc[p]);
    put_i64(&h, s->local_last[p]);
    int64_t last_added = ggrs_sync_last_added(s->sync, p);
    int64_t start = kNullFrame;
    int64_t count = 0;
    if (last_added != kNullFrame) {
      // one frame DEEPER than the watermark: the watermark discard keeps
      // last_confirmed-1, and eviction may resume there when the fault
      // tick's own save of the watermark frame was suppressed
      start = s->last_confirmed > 1 ? s->last_confirmed - 1 : 0;
      int64_t tail = ggrs_sync_tail_frame(s->sync, p);
      if (tail != kNullFrame && tail > start) start = tail;
      if (start > last_added) start = last_added;
      count = last_added - start + 1;
      int64_t qlen = ggrs_sync_queue_len();  // the ring can never hold more
      if (count > qlen) {
        start = last_added - (qlen - 1);
        count = qlen;
      }
    }
    put_i64(&h, start);
    put_u32(&h, static_cast<uint32_t>(count));
    for (int64_t f = start; count > 0 && f <= last_added; ++f) {
      if (ggrs_sync_confirmed_input(s->sync, p, f, input_buf.data()) != 0) {
        return kBankErrCmd;  // hole in the queue: harvest contract broken
      }
      put_raw(&h, input_buf.data(), input_buf.size());
    }
  }
  put_u8(&h, static_cast<uint8_t>(s->endpoints.size()));
  std::vector<uint8_t> scratch(size_t{1} << 14);
  for (BankEndpoint& ep : s->endpoints) {
    put_u8(&h, ep.state);
    // peer status mirrors (what this peer last reported about every
    // player): the vectorized pool skips the per-tick mirror parse on
    // quiet ticks, so eviction/export read the authoritative copy HERE
    // instead of trusting a possibly-stale Python-side mirror
    for (int p = 0; p < s->num_players; ++p) {
      put_u8(&h, ep.peer_disc[p]);
      put_i64(&h, ep.peer_last[p]);
    }
    for (int which = 0; which < 2; ++which) {
      size_t need = 0;
      while (true) {
        int rc = which == 0
                     ? ggrs_ep_dump_send(ep.ep, scratch.data(),
                                         scratch.size(), &need)
                     : ggrs_ep_dump_recv(ep.ep, scratch.data(),
                                         scratch.size(), &need);
        if (rc == kErrBufferTooSmall) {
          scratch.resize(need);
          continue;
        }
        if (rc != kOk) return kBankErrCmd;
        break;
      }
      put_raw(&h, scratch.data(), need);
    }
  }
  put_i64(&h, s->next_spectator_frame);
  put_u8(&h, static_cast<uint8_t>(s->spectators.size()));
  for (BankEndpoint& sp : s->spectators) {
    put_u8(&h, sp.state);
    size_t need = 0;
    while (true) {
      int rc = ggrs_ep_dump_send(sp.ep, scratch.data(), scratch.size(),
                                 &need);
      if (rc == kErrBufferTooSmall) {
        scratch.resize(need);
        continue;
      }
      if (rc != kOk) return kBankErrCmd;
      break;
    }
    put_raw(&h, scratch.data(), need);
  }
  // staged-inputs tail (descriptor plane, §21): inputs staged via
  // ggrs_bank_stage_inputs that no advance has consumed yet — a FAULTED
  // tick keeps them, and eviction/export must re-feed them to the
  // fallback session exactly like the Python-side staged dict.
  //   u8 n_staged; per staged handle: i32 handle, input_size bytes
  put_u8(&h, static_cast<uint8_t>(s->staged_count));
  for (size_t j = 0; j < s->local_handles.size(); ++j) {
    if (!s->staged_mask[j]) continue;
    put_u32(&h, static_cast<uint32_t>(s->local_handles[j]));
    put_raw(&h, s->staged_local.data() +
                    j * static_cast<size_t>(s->input_size),
            static_cast<size_t>(s->input_size));
  }
  *out_len = h.size();
  if (h.size() > cap) return kErrBufferTooSmall;
  std::memcpy(out, h.data(), h.size());
  return kBankOk;
}

// THE stat harvest (DESIGN.md §12): dump every slot's protocol/sync
// counters in ONE crossing per scrape — the observability sibling of
// ggrs_bank_tick's one-crossing-per-tick invariant.  Read-only: safe to
// call at any time between ticks, never perturbs the bank (quarantined
// slots report their frozen state).  Little-endian layout, per session
// in index order:
//   i64 current_frame, i64 last_confirmed
//   u64 ticks, u64 rollbacks, u64 rollback_frames, u64 max_rollback_depth
//   u64 faults
//   u8 n_endpoints; per endpoint:
//     u8 state
//     i64 rtt_ms, i64 send_queue_len, i64 last_acked_frame,
//     i64 last_recv_frame
//     i64 local_frame_advantage, i64 remote_frame_advantage,
//     i64 frame_advantage_avg (the time-sync window average)
//     i64 packets_sent, i64 bytes_sent, i64 stats_start_ms
//     7 * u64 endpoint-core counters (ggrs_ep_stats order: emits,
//       emit_bytes, acks, datagrams, new_frames, drops, fallbacks)
//   i64 next_spectator_frame
//   u8 n_spectators; per spectator:
//     u8 state, i64 last_acked_frame, i64 pending_len, i64 rtt_ms,
//     i64 packets_sent, i64 bytes_sent, i64 stats_start_ms
//   (the catchup-lag gauge is (next_spectator_frame-1) - last_acked_frame;
//   harvested in the SAME crossing as everything else)
//   u8 has_io; [if 1] 22 * u64 NetBatch counters (ggrs_net_stats order:
//     recv_calls, recv_datagrams, send_calls, send_datagrams, send_errors,
//     oversized, 8 recv batch-size buckets, 8 send batch-size buckets) —
//   the batched datapath's syscall/batch observability rides the SAME
//   one-crossing scrape (DESIGN.md §15)
// When the phase timers are armed (ggrs_bank_set_timing), a cumulative
// timing tail follows the last session:
//   u64 timed_ticks, kNumPhases * u64 total_phase_ns, u8 n_phases
// Returns kBankOk or kErrBufferTooSmall (*out_len = needed; retry).
int ggrs_bank_stats(void* ptr, uint8_t* out, size_t cap, size_t* out_len) {
  Bank* bank = static_cast<Bank*>(ptr);
  std::vector<uint8_t> h;
  uint64_t core[7];
  for (BankSession* s : bank->sessions) {
    put_i64(&h, s->current_frame);
    put_i64(&h, s->last_confirmed);
    put_u64(&h, s->stat_ticks);
    put_u64(&h, s->stat_rollbacks);
    put_u64(&h, s->stat_rollback_frames);
    put_u64(&h, s->stat_max_rollback);
    put_u64(&h, s->stat_faults);
    put_u8(&h, static_cast<uint8_t>(s->endpoints.size()));
    for (BankEndpoint& ep : s->endpoints) {
      put_u8(&h, ep.state);
      put_i64(&h, ep.rtt);
      put_i64(&h, ggrs_ep_pending_len(ep.ep));
      put_i64(&h, ggrs_ep_last_acked_frame(ep.ep));
      put_i64(&h, ggrs_ep_last_recv_frame(ep.ep));
      put_i64(&h, ep.local_adv);
      put_i64(&h, ep.remote_adv);
      put_i64(&h, ep.ts_average());
      put_i64(&h, ep.packets_sent);
      put_i64(&h, ep.bytes_sent);
      put_i64(&h, ep.stats_start);
      ggrs_ep_stats(ep.ep, core);
      for (int i = 0; i < 7; ++i) put_u64(&h, core[i]);
    }
    put_i64(&h, s->next_spectator_frame);
    put_u8(&h, static_cast<uint8_t>(s->spectators.size()));
    for (BankEndpoint& sp : s->spectators) {
      put_u8(&h, sp.state);
      put_i64(&h, ggrs_ep_last_acked_frame(sp.ep));
      put_i64(&h, ggrs_ep_pending_len(sp.ep));
      put_i64(&h, sp.rtt);
      put_i64(&h, sp.packets_sent);
      put_i64(&h, sp.bytes_sent);
      put_i64(&h, sp.stats_start);
    }
    put_u8(&h, s->net ? 1 : 0);
    if (s->net) {
      uint64_t io[kNumNetStats];
      ggrs_net_stats(s->net, io);
      for (int i = 0; i < kNumNetStats; ++i) put_u64(&h, io[i]);
    }
  }
  if (bank->timing) {
    put_u64(&h, bank->timed_ticks);
    for (int i = 0; i < kNumPhases; ++i) put_u64(&h, bank->phase_total[i]);
    put_u8(&h, static_cast<uint8_t>(kNumPhases));
  }
  *out_len = h.size();
  if (h.size() > cap) return kErrBufferTooSmall;
  std::memcpy(out, h.data(), h.size());
  return kBankOk;
}

}  // extern "C"
