// The VectorWar step (the GGPO SDK's sample game, GameState::Update in 16.16
// fixed point): one launch a frame for a whole batch of sessions, a warp a
// session, each session's state and inputs read once and its new state
// written once.
//
// Replaces no TPU kernel: the JAX package has no VectorWar.  The port's eager
// body (games/vectorwar.py, VectorWar._advance_eager) computes the same
// integers in about a hundred PyTorch operations, each reading and writing
// whole (B, 4, 30, ...) intermediates, and the hit test's (B, 4, 30, 4, 2)
// int64 gaps; this kernel keeps all of that in registers.
//
// Per frame, for ship i = 0 .. 3 in order, exactly as the eager body:
//   heading' = (heading + 3 right | -3 left | 0) mod 360 (floored)
//   c, s     = sin_lut[(heading' + 90) mod 360], sin_lut[heading']
//   fire     : cooldown 0, fire held, a free slot: the first free slot k gets
//              pos + 15 (c, s), vel + 5 (c, s) (the velocity before thrust),
//              and cooldown = 8
//   thrust   : t = +3932 thrust | -3932 brake | 0; vel += (t c >> 16, t s >> 16);
//              where t != 0 and m = isqrt(vx^2 + vy^2) (int64, exact) > 4 << 16,
//              vel = vel * (4 << 16) / m (int64, truncated)
//   move     : pos += vel; an axis whose pos -+ 15 px leaves [16, 624] x
//              [16, 464] px negates its velocity and adds it twice
//   bullets  : each live bullet of ship i moves; outside the bounds it dies,
//              else the first ship j (in order) with (bullet - ship j)^2 <
//              (15 px)^2 (int64) scores for i, costs j 10 health, and kills
//              it; ships j <= i are tested where they moved to this frame,
//              ships j > i where they were
//   cooldown : counts down by 1 to 0
// >> is arithmetic, int64 '/' truncates as torch.div(rounding_mode="trunc"),
// and mod is torch.remainder's floored remainder.  Within the states frames
// reach (every word within +-2^29) no int32 sum overflows.  An input
// element of any integer dtype is read by its low byte.
//
// Bound: device memory.  A four-ship session reads 2,528 bytes of state and
// 4 input elements and writes 2,528 bytes, for a few hundred integer
// operations a ship: below the card's operations-per-byte balance.  What the
// design does about it:
// - a warp a session: lane s < 30 holds bullet slot s of every ship, so the
//   bullets' loads and stores are 120-, 240- and 240-byte coalesced spans a
//   ship; the first free slot is a __ballot_sync and __ffs, and the hits a
//   ship scores and takes are __ballot_sync and __popc counts;
// - lane k computes ship k % 4's move (all lanes the same instructions, no
//   divergence), and __shfl_sync hands each ship's fire, new bullet and
//   positions before and after its move to every lane, so the ships' order
//   within a frame costs no pass over memory;
// - every leaf is read in place: the wrapper passes each leaf's session
//   stride, so a ring slot view (stride R x the leaf's row) is read without a
//   copy; only the inner dimensions must be contiguous;
// - the new state is written once, to the nine contiguous outputs the
//   wrapper allocates; nothing else touches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // sessions a block
constexpr int kThreads = kWarps * 32;
constexpr int kLeaves = 9;
constexpr int kShips = 4;
constexpr int kSlots = 30;
constexpr int kFp = 16;
constexpr int kDegrees = 360;
constexpr int kRotate = 3;
constexpr int kRadius = 15 << kFp;
constexpr int kThrust = 3932;  // int(0.06 * 65536)
constexpr int kMaxThrust = 4 << kFp;
constexpr int kBulletSpeed = 5;
constexpr int kCooldown = 8;
constexpr int kDamage = 10;
constexpr int kLeft = 16 << kFp;
constexpr int kTop = 16 << kFp;
constexpr int kRight = 624 << kFp;
constexpr int kBottom = 464 << kFp;
constexpr long long kRadius2 = (long long)kRadius * kRadius;
constexpr unsigned kAll = 0xffffffffu;

// the leaves in sorted key order
enum Leaf { kActive, kBulletPos, kBulletVel, kCool, kHeading, kHealth, kPos, kScore, kVel };

struct Args {
  const char* in[kLeaves];  // session 0's row of each leaf
  long long stride[kLeaves];  // bytes from one session's row to the next
  char* out[kLeaves];  // contiguous rows
  const unsigned char* inp;
  long long inp_stride;
  long long inp_item;  // bytes of one input element
  const int* lut;  // 360 int32
  long long rows;
};

template <typename T>
__device__ __forceinline__ const T* row(const Args& a, int leaf, long long r) {
  return reinterpret_cast<const T*>(a.in[leaf] + r * a.stride[leaf]);
}

template <typename T>
__device__ __forceinline__ T* out_row(const Args& a, int leaf, long long r, int words) {
  return reinterpret_cast<T*>(a.out[leaf]) + r * words;
}

// torch.remainder of an int32 by a positive divisor
__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// floor(sqrt(n)), exact: a double root, moved by one where it rounded across
// an integer
__device__ __forceinline__ long long isqrt(long long n) {
  long long root = (long long)floor(sqrt((double)n));
  if (root * root > n) --root;
  if ((root + 1) * (root + 1) <= n) ++root;
  return root;
}

__device__ __forceinline__ int2 shfl2(int2 v, int lane) {
  return make_int2(__shfl_sync(kAll, v.x, lane), __shfl_sync(kAll, v.y, lane));
}

__global__ void __launch_bounds__(kThreads) vectorwar_advance_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= a.rows) return;  // a whole warp: one session
  const bool holds_slot = lane < kSlots;

  // this lane's bullet slot of every ship (lanes 30, 31 hold none: inactive)
  int act[kShips];
  int2 bpos[kShips], bvel[kShips];
#pragma unroll
  for (int i = 0; i < kShips; ++i) {
    act[i] = 0;
    bpos[i] = bvel[i] = make_int2(0, 0);
    if (holds_slot) {
      act[i] = __ldg(row<int>(a, kActive, r) + i * kSlots + lane);
      bpos[i] = __ldg(row<int2>(a, kBulletPos, r) + i * kSlots + lane);
      bvel[i] = __ldg(row<int2>(a, kBulletVel, r) + i * kSlots + lane);
    }
  }
  unsigned free_mask[kShips];
#pragma unroll
  for (int i = 0; i < kShips; ++i) free_mask[i] = __ballot_sync(kAll, holds_slot && act[i] == 0);

  // ship k's move (lanes 0 .. 3 are read below)
  const int k = lane % kShips;
  const int bits = __ldg(a.inp + r * a.inp_stride + k * a.inp_item);
  const int2 pos0 = __ldg(row<int2>(a, kPos, r) + k);
  const int2 vel0 = __ldg(row<int2>(a, kVel, r) + k);
  int cooldown = __ldg(row<int>(a, kCool, r) + k);
  const int turn = (bits & 8) ? kRotate : (bits & 4) ? -kRotate : 0;
  const int heading = floor_mod(__ldg(row<int>(a, kHeading, r) + k) + turn, kDegrees);
  const int c = __ldg(a.lut + (heading + 90) % kDegrees);
  const int s = __ldg(a.lut + heading);
  unsigned mine = free_mask[0];
#pragma unroll
  for (int i = 1; i < kShips; ++i) mine = k == i ? free_mask[i] : mine;
  const bool shoot = cooldown == 0 && (bits & 16) && mine != 0;
  const int first_free = __ffs(mine) - 1;
  const int2 fired_pos = make_int2(pos0.x + 15 * c, pos0.y + 15 * s);
  const int2 fired_vel = make_int2(vel0.x + kBulletSpeed * c, vel0.y + kBulletSpeed * s);
  if (shoot) cooldown = kCooldown;
  const int thrust = (bits & 1) ? kThrust : (bits & 2) ? -kThrust : 0;
  int2 vel = make_int2(vel0.x + ((thrust * c) >> kFp), vel0.y + ((thrust * s) >> kFp));
  if (thrust != 0) {
    const long long vx = vel.x, vy = vel.y;
    const long long speed = isqrt(vx * vx + vy * vy);
    if (speed > kMaxThrust) {
      vel.x = (int)(vx * kMaxThrust / speed);
      vel.y = (int)(vy * kMaxThrust / speed);
    }
  }
  int2 pos = make_int2(pos0.x + vel.x, pos0.y + vel.y);
  if (pos.x - kRadius < kLeft || pos.x + kRadius > kRight) {
    vel.x = -vel.x;
    pos.x += 2 * vel.x;
  }
  if (pos.y - kRadius < kTop || pos.y + kRadius > kBottom) {
    vel.y = -vel.y;
    pos.y += 2 * vel.y;
  }
  if (cooldown > 0) --cooldown;

  // every ship's fire and positions, handed to every lane
  int2 before[kShips], after[kShips];
#pragma unroll
  for (int i = 0; i < kShips; ++i) {
    const bool shot = __shfl_sync(kAll, (int)shoot, i);
    const int slot = __shfl_sync(kAll, first_free, i);
    const int2 np = shfl2(fired_pos, i), nv = shfl2(fired_vel, i);
    before[i] = shfl2(pos0, i);
    after[i] = shfl2(pos, i);
    if (shot && lane == slot) {
      act[i] = 1;
      bpos[i] = np;
      bvel[i] = nv;
    }
  }

  // ship i's bullets, in ship order: move, leave the bounds, or hit
  int target[kShips];
#pragma unroll
  for (int i = 0; i < kShips; ++i) {
    target[i] = -1;
    if (act[i]) {
      bpos[i].x += bvel[i].x;
      bpos[i].y += bvel[i].y;
      if (bpos[i].x < kLeft || bpos[i].y < kTop || bpos[i].x > kRight || bpos[i].y > kBottom) {
        act[i] = 0;
      } else {
#pragma unroll
        for (int j = kShips - 1; j >= 0; --j) {  // the last test that holds is the first ship
          const int2 t = j <= i ? after[j] : before[j];
          const long long dx = (long long)bpos[i].x - t.x, dy = (long long)bpos[i].y - t.y;
          if (dx * dx + dy * dy < kRadius2) target[i] = j;
        }
        if (target[i] >= 0) act[i] = 0;
      }
    }
  }
  int scored = 0, taken = 0;  // ship k's
#pragma unroll
  for (int i = 0; i < kShips; ++i) {
    const int n = __popc(__ballot_sync(kAll, target[i] >= 0));
    scored = k == i ? n : scored;
#pragma unroll
    for (int j = 0; j < kShips; ++j) {
      const int m = __popc(__ballot_sync(kAll, target[i] == j));
      taken += k == j ? m : 0;
    }
  }

  if (holds_slot) {
#pragma unroll
    for (int i = 0; i < kShips; ++i) {
      out_row<int>(a, kActive, r, kShips * kSlots)[i * kSlots + lane] = act[i];
      out_row<int2>(a, kBulletPos, r, kShips * kSlots)[i * kSlots + lane] = bpos[i];
      out_row<int2>(a, kBulletVel, r, kShips * kSlots)[i * kSlots + lane] = bvel[i];
    }
  }
  if (lane < kShips) {
    out_row<int>(a, kCool, r, kShips)[lane] = cooldown;
    out_row<int>(a, kHeading, r, kShips)[lane] = heading;
    out_row<int>(a, kHealth, r, kShips)[lane] = __ldg(row<int>(a, kHealth, r) + lane) - kDamage * taken;
    out_row<int2>(a, kPos, r, kShips)[lane] = pos;
    out_row<int>(a, kScore, r, kShips)[lane] = __ldg(row<int>(a, kScore, r) + lane) + scored;
    out_row<int2>(a, kVel, r, kShips)[lane] = vel;
  }
}

}  // namespace

// The constants the kernel is compiled with, for the wrapper to hold against
// its own: ships, slots, fixed-point shift, rotate step, radius, thrust, max thrust,
// bullet speed, cooldown, damage, and the bounds' left, top, right, bottom.
extern "C" void ggrs_vectorwar_constants(long long* out) {
  const long long c[14] = {kShips, kSlots, kFp, kRotate, kRadius, kThrust, kMaxThrust, kBulletSpeed,
                           kCooldown, kDamage, kLeft, kTop, kRight, kBottom};
  for (int i = 0; i < 14; ++i) out[i] = c[i];
}

// One VectorWar step for `rows` sessions.  leaves[9]: session 0's row of
// bullet_active (4, 30), bullet_pos (4, 30, 2), bullet_vel (4, 30, 2),
// cooldown, heading, health (4), pos (4, 2), score (4), vel (4, 2), all
// int32, strides[9] bytes apart (the pair leaves' rows 8-byte aligned); inp:
// rows of 4 elements of inp_item bytes,
// of which the low (first) byte is read.  outs[9]: contiguous int32
// outputs in the same order, written whole.  lut: the 360 int32 sine table
// on the device.  Launches on `stream`, allocates nothing, does not
// synchronise, and returns 0 or a CUDA error code (cudaGetLastError() after
// the launch); rows = 0 launches nothing.
extern "C" int ggrs_vectorwar_advance(long long rows, const void* const* leaves,
                                      const long long* strides, const void* inp,
                                      long long inp_stride, long long inp_item,
                                      void* const* outs, const void* lut, void* stream) {
  if (rows < 0 || inp_item < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if ((rows + kWarps - 1) / kWarps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  for (int i = 0; i < kLeaves; ++i) {
    a.in[i] = static_cast<const char*>(leaves[i]);
    a.stride[i] = strides[i];
    a.out[i] = static_cast<char*>(outs[i]);
  }
  a.inp = static_cast<const unsigned char*>(inp);
  a.inp_stride = inp_stride;
  a.inp_item = inp_item;
  a.lut = static_cast<const int*>(lut);
  a.rows = rows;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  vectorwar_advance_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
