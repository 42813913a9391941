// Native sync-layer mechanism: the per-player input-queue bank and the
// confirmed-frame watermark, exactly mirroring the Python reference cores
// (ggrs_tpu_torch/core/input_queue.py, ggrs_tpu_torch/core/sync_layer.py;
// behavior spec: GGRS src/input_queue.rs:104-265 and
// src/sync_layer.rs:168-375).
//
// Policy stays in Python (what frame to confirm under sparse saving, when to
// roll back, session orchestration); this file owns only the MECHANISM: ring
// maintenance, frame-delay insertion, repeat-last prediction with
// first-incorrect tracking, synchronized/confirmed input assembly, and
// confirmed-frame discard — the ops the capacity bench measured at ~90% of a
// pooled hosting tick when run as ~200 Python calls per session-tick.
//
// Inputs are fixed-size encoded byte blobs (Config.native_input_size);
// repeat-last prediction and equality are byte-wise, which matches the
// Python semantics whenever the encoding is injective (the for_uint /
// for_struct constructors).  Anything else — pluggable predictors, custom
// equality, variable-size inputs — stays on the Python core, selected at
// SyncLayer construction.

#include "wire_common.h"

#include <cstdlib>
#include <cstring>
#include <new>

namespace {

using i64 = int64_t;

constexpr int kQueueLen = 128;          // input_queue.py INPUT_QUEUE_LENGTH
constexpr i64 kNullFrame = -1;

// error codes (mirrored in _native.py as SYNC_ERR_*)
enum SyncRc : int {
  kSyncOk = 0,
  kSyncErrPredictionPending = -40,  // input() while first_incorrect set
  kSyncErrBeforeTail = -41,         // input() for a frame older than tail
  kSyncErrNoConfirmed = -42,        // confirmed_input() miss
  kSyncErrNonSequential = -43,      // _add_input_by_frame precondition
  kSyncErrConfirmPastIncorrect = -44,  // watermark past first_incorrect
  kSyncErrBadArgs = -45,
  kSyncErrQueueFull = -46,             // 128-slot ring exhausted
};

// input status codes (mirror core/types.py InputStatus order)
enum : int {
  kStatusConfirmed = 0,
  kStatusPredicted = 1,
  kStatusDisconnected = 2,
};

struct Queue {
  int head = 0;
  int tail = 0;
  int length = 0;
  bool first_frame = true;
  i64 last_added = kNullFrame;
  i64 first_incorrect = kNullFrame;
  i64 last_requested = kNullFrame;
  int frame_delay = 0;
  i64 pred_frame = kNullFrame;
  std::vector<uint8_t> pred_input;
  std::vector<i64> frames;          // kQueueLen slot frames
  std::vector<uint8_t> arena;       // kQueueLen * input_size input bytes
};

struct SyncCore {
  int players = 0;
  int input_size = 0;
  i64 last_confirmed = kNullFrame;
  std::vector<Queue> queues;

  uint8_t* slot_bytes(Queue& q, int idx) {
    return q.arena.data() + static_cast<size_t>(idx) * input_size;
  }
};

// ---- queue mechanics: 1:1 with input_queue.py --------------------------

void add_input_by_frame(SyncCore* c, Queue& q, const uint8_t* bytes,
                        i64 frame_number, int* rc) {
  int prev_pos = (q.head - 1 + kQueueLen) % kQueueLen;
  if (!(q.last_added == kNullFrame || frame_number == q.last_added + 1) ||
      !(frame_number == 0 || q.frames[prev_pos] == frame_number - 1)) {
    *rc = kSyncErrNonSequential;
    return;
  }
  if (q.length >= kQueueLen) {
    // the Python core raises at the same point (input_queue.py:154);
    // silently wrapping would overwrite the tail and serve wrong inputs
    *rc = kSyncErrQueueFull;
    return;
  }
  // compare prediction vs reality BEFORE the input enters the ring
  bool prediction_matches =
      q.pred_frame != kNullFrame &&
      std::memcmp(q.pred_input.data(), bytes, c->input_size) == 0;

  q.frames[q.head] = frame_number;
  std::memcpy(c->slot_bytes(q, q.head), bytes, c->input_size);
  q.head = (q.head + 1) % kQueueLen;
  q.length += 1;
  q.first_frame = false;
  q.last_added = frame_number;

  if (q.pred_frame != kNullFrame) {
    if (frame_number != q.pred_frame) {
      *rc = kSyncErrNonSequential;
      return;
    }
    if (q.first_incorrect == kNullFrame && !prediction_matches) {
      q.first_incorrect = frame_number;
    }
    if (q.pred_frame == q.last_requested &&
        q.first_incorrect == kNullFrame) {
      q.pred_frame = kNullFrame;
    } else {
      q.pred_frame += 1;
    }
  }
}

i64 advance_queue_head(SyncCore* c, Queue& q, const uint8_t* bytes,
                       i64 input_frame, int* rc) {
  int prev_pos = (q.head - 1 + kQueueLen) % kQueueLen;
  i64 expected = q.first_frame ? 0 : q.frames[prev_pos] + 1;
  input_frame += q.frame_delay;
  if (expected > input_frame) return kNullFrame;  // delay shrank: drop
  while (expected < input_frame) {                // delay grew: replicate
    int rep = (q.head - 1 + kQueueLen) % kQueueLen;
    // Python replicates PlayerInput(replicate.frame, replicate.input) but
    // passes the EXPECTED frame to _add_input_by_frame — copy the bytes
    // before the head moves
    std::vector<uint8_t> rep_bytes(c->slot_bytes(q, rep),
                                   c->slot_bytes(q, rep) + c->input_size);
    add_input_by_frame(c, q, rep_bytes.data(), expected, rc);
    if (*rc != kSyncOk) return kNullFrame;
    expected += 1;
  }
  return input_frame;
}

i64 queue_add_input(SyncCore* c, Queue& q, i64 frame, const uint8_t* bytes,
                    int* rc) {
  if (q.last_added != kNullFrame &&
      frame + q.frame_delay != q.last_added + 1) {
    return kNullFrame;  // non-sequential: dropped, as in Python
  }
  i64 new_frame = advance_queue_head(c, q, bytes, frame, rc);
  if (*rc != kSyncOk) return kNullFrame;
  if (new_frame != kNullFrame) {
    add_input_by_frame(c, q, bytes, new_frame, rc);
    if (*rc != kSyncOk) return kNullFrame;
  }
  return new_frame;
}

// input_queue.py input(): confirmed value or repeat-last prediction
int queue_input(SyncCore* c, Queue& q, i64 requested, uint8_t* out,
                int* status) {
  if (q.first_incorrect != kNullFrame) return kSyncErrPredictionPending;
  q.last_requested = requested;
  if (requested < q.frames[q.tail]) return kSyncErrBeforeTail;

  if (q.pred_frame < 0) {
    i64 offset = requested - q.frames[q.tail];
    if (offset < q.length) {
      int pos = static_cast<int>((offset + q.tail) % kQueueLen);
      if (q.frames[pos] != requested) return kSyncErrBadArgs;
      std::memcpy(out, c->slot_bytes(q, pos), c->input_size);
      *status = kStatusConfirmed;
      return kSyncOk;
    }
    // enter prediction mode: repeat the most recently added input
    if (requested != 0 && q.last_added != kNullFrame) {
      int prev_pos = (q.head - 1 + kQueueLen) % kQueueLen;
      std::memcpy(q.pred_input.data(), c->slot_bytes(q, prev_pos),
                  c->input_size);
      q.pred_frame = q.frames[prev_pos] + 1;
    } else {
      std::memset(q.pred_input.data(), 0, c->input_size);
      q.pred_frame = q.pred_frame + 1;  // base_frame = pred_frame (NULL) + 1
    }
  }
  if (q.pred_frame == kNullFrame) return kSyncErrBadArgs;
  std::memcpy(out, q.pred_input.data(), c->input_size);
  *status = kStatusPredicted;
  return kSyncOk;
}

void queue_discard_confirmed(Queue& q, i64 frame) {
  if (q.last_requested != kNullFrame && q.last_requested < frame) {
    frame = q.last_requested;
  }
  if (frame >= q.last_added) {
    q.tail = q.head;
    q.length = 1;
  } else if (frame <= q.frames[q.tail]) {
    // nothing to delete
  } else {
    i64 offset = frame - q.frames[q.tail];
    q.tail = static_cast<int>((q.tail + offset) % kQueueLen);
    q.length -= static_cast<int>(offset);
  }
}

}  // namespace

// ---- C API ----------------------------------------------------------------

extern "C" {

void* ggrs_sync_new(int players, int input_size) {
  if (players < 1 || players > 64 || input_size < 1 || input_size > 4096) {
    return nullptr;
  }
  SyncCore* c = new (std::nothrow) SyncCore();
  if (!c) return nullptr;
  c->players = players;
  c->input_size = input_size;
  c->queues.resize(players);
  for (Queue& q : c->queues) {
    q.frames.assign(kQueueLen, kNullFrame);
    q.arena.assign(static_cast<size_t>(kQueueLen) * input_size, 0);
    q.pred_input.assign(input_size, 0);
  }
  return c;
}

void ggrs_sync_free(void* h) { delete static_cast<SyncCore*>(h); }

void ggrs_sync_set_frame_delay(void* h, int player, int delay) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players) return;
  c->queues[player].frame_delay = delay;
}

void ggrs_sync_reset_prediction(void* h) {
  SyncCore* c = static_cast<SyncCore*>(h);
  for (Queue& q : c->queues) {
    q.pred_frame = kNullFrame;
    q.first_incorrect = kNullFrame;
    q.last_requested = kNullFrame;
  }
}

// returns the landed frame, kNullFrame when dropped, or a SyncRc error (<-1)
int64_t ggrs_sync_add_input(void* h, int player, int64_t frame,
                            const uint8_t* bytes) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players) return kSyncErrBadArgs;
  int rc = kSyncOk;
  i64 landed = queue_add_input(c, c->queues[player], frame, bytes, &rc);
  return rc == kSyncOk ? landed : rc;
}

// synchronized inputs for `frame` given per-player connect status.
// disc: players u8; last_frames: players i64; out: players*input_size bytes;
// statuses: players i32 (kStatus*)
int ggrs_sync_synchronized_inputs(void* h, int64_t frame,
                                  const uint8_t* disc,
                                  const int64_t* last_frames, uint8_t* out,
                                  int32_t* statuses) {
  SyncCore* c = static_cast<SyncCore*>(h);
  for (int p = 0; p < c->players; ++p) {
    uint8_t* dst = out + static_cast<size_t>(p) * c->input_size;
    if (disc[p] && last_frames[p] < frame) {
      std::memset(dst, 0, c->input_size);
      statuses[p] = kStatusDisconnected;
    } else {
      int st = 0;
      int rc = queue_input(c, c->queues[p], frame, dst, &st);
      if (rc != kSyncOk) return rc;
      statuses[p] = st;
    }
  }
  return kSyncOk;
}

// confirmed inputs for `frame`; out_frames[p] carries each slot's stored
// frame (kNullFrame for disconnected blanks, matching PlayerInput.blank)
int ggrs_sync_confirmed_inputs(void* h, int64_t frame, const uint8_t* disc,
                               const int64_t* last_frames, uint8_t* out,
                               int64_t* out_frames) {
  SyncCore* c = static_cast<SyncCore*>(h);
  for (int p = 0; p < c->players; ++p) {
    Queue& q = c->queues[p];
    uint8_t* dst = out + static_cast<size_t>(p) * c->input_size;
    if (disc[p] && last_frames[p] < frame) {
      std::memset(dst, 0, c->input_size);
      out_frames[p] = kNullFrame;
      continue;
    }
    // floored mod: C++ % on a negative frame is negative (out-of-bounds UB);
    // Python's positive mod lands on a real slot, which for most negative
    // frames fails the tag check loudly — and for frame -1 legitimately
    // matches a still-blank slot (frames init to kNullFrame), so an early
    // "frame < 0" rejection would NOT be parity
    int offset = static_cast<int>(((frame % kQueueLen) + kQueueLen) % kQueueLen);
    if (q.frames[offset] != frame) return kSyncErrNoConfirmed;
    std::memcpy(dst, c->slot_bytes(q, offset), c->input_size);
    out_frames[p] = frame;
  }
  return kSyncOk;
}

// watermark: `frame` is the POLICY-resolved confirmed frame (Python already
// applied the sparse-saving and current-frame minimums).  Verifies the
// first-incorrect invariant, stores, and discards <= frame-1.
int ggrs_sync_set_last_confirmed(void* h, int64_t frame) {
  SyncCore* c = static_cast<SyncCore*>(h);
  i64 first_incorrect = kNullFrame;
  for (Queue& q : c->queues) {
    if (q.first_incorrect > first_incorrect) {
      first_incorrect = q.first_incorrect;
    }
  }
  if (!(first_incorrect == kNullFrame || first_incorrect >= frame)) {
    return kSyncErrConfirmPastIncorrect;
  }
  c->last_confirmed = frame;
  if (frame > 0) {
    for (Queue& q : c->queues) queue_discard_confirmed(q, frame - 1);
  }
  return kSyncOk;
}

int64_t ggrs_sync_last_confirmed(void* h) {
  return static_cast<SyncCore*>(h)->last_confirmed;
}

// earliest incorrect frame across queues, folded with the caller's seed
// (sync_layer.py check_simulation_consistency)
int64_t ggrs_sync_check_consistency(void* h, int64_t first_incorrect) {
  SyncCore* c = static_cast<SyncCore*>(h);
  for (Queue& q : c->queues) {
    i64 inc = q.first_incorrect;
    if (inc != kNullFrame &&
        (first_incorrect == kNullFrame || inc < first_incorrect)) {
      first_incorrect = inc;
    }
  }
  return first_incorrect;
}

int64_t ggrs_sync_first_incorrect(void* h, int player) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players) return kSyncErrBadArgs;
  return c->queues[player].first_incorrect;
}

int64_t ggrs_sync_last_added(void* h, int player) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players) return kSyncErrBadArgs;
  return c->queues[player].last_added;
}

// the per-player ring capacity (session_bank.cpp's harvest clamps against
// this instead of duplicating the literal)
int ggrs_sync_queue_len(void) { return kQueueLen; }

// oldest frame still held by a player's queue (kNullFrame when empty) —
// the lower bound of what a harvest can recover for fallback eviction
int64_t ggrs_sync_tail_frame(void* h, int player) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players) return kSyncErrBadArgs;
  Queue& q = c->queues[player];
  return q.length > 0 ? q.frames[q.tail] : kNullFrame;
}

// Seed one player's EMPTY queue with `count` consecutive confirmed inputs
// for frames [start, start+count) — the adoption path of fallback eviction.
// Slots are placed at frame % kQueueLen, preserving the invariant normal
// sequential insertion from frame 0 establishes (confirmed_input addresses
// by frame-mod while queue_input walks from the tail).
int ggrs_sync_seed(void* h, int player, int64_t start, int32_t count,
                   const uint8_t* bytes) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players || start < 0 || count < 0 ||
      count > kQueueLen) {
    return kSyncErrBadArgs;
  }
  Queue& q = c->queues[player];
  if (q.last_added != kNullFrame || q.length != 0) return kSyncErrBadArgs;
  if (count == 0) return kSyncOk;
  for (int32_t i = 0; i < count; ++i) {
    i64 frame = start + i;
    int slot = static_cast<int>(frame % kQueueLen);
    q.frames[slot] = frame;
    std::memcpy(c->slot_bytes(q, slot), bytes + static_cast<size_t>(i) * c->input_size,
                c->input_size);
  }
  q.tail = static_cast<int>(start % kQueueLen);
  q.head = static_cast<int>((start + count) % kQueueLen);
  q.length = count;
  q.first_frame = false;
  q.last_added = start + count - 1;
  return kSyncOk;
}

// confirmed_input for one player (input_queue.py confirmed_input): exact
// slot match required
int ggrs_sync_confirmed_input(void* h, int player, int64_t frame,
                              uint8_t* out) {
  SyncCore* c = static_cast<SyncCore*>(h);
  if (player < 0 || player >= c->players) return kSyncErrBadArgs;
  Queue& q = c->queues[player];
  // floored mod, same reasoning as ggrs_sync_confirmed_inputs: negative %
  // is out-of-bounds UB in C++, and Python-parity for frame -1 means
  // matching the blank slot, not rejecting all negatives up front
  int offset = static_cast<int>(((frame % kQueueLen) + kQueueLen) % kQueueLen);
  if (q.frames[offset] != frame) return kSyncErrNoConfirmed;
  std::memcpy(out, c->slot_bytes(q, offset), c->input_size);
  return kSyncOk;
}

}  // extern "C"
