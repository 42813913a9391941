// The BoxGame fixed-point step: one launch a frame for a whole batch of
// sessions, each session's state and inputs read once and its new state
// written once.
//
// Replaces no TPU kernel.  ggrs_tpu/games/boxgame.py's advance is one jnp
// expression that XLA fuses into a single pass on the TPU; the port's eager
// body (games/boxgame.py, BoxGame._advance_fixed) runs the same integers as
// 31 elementwise PyTorch operations, 33 kernels on the card, each reading and
// writing whole (B, P) or (B, P, 2) intermediates.  This kernel is that fusion, written by hand.
//
// Per player, in int32 exactly as the eager body computes it:
//   turn   = right - left, thrust = up - down  (bits 3, 2, 0, 1 of the input)
//   rot'   = (rot + 3 turn) mod 256
//   c, s   = sin_lut[(rot' + 64) mod 256], sin_lut[rot']
//   acc    = thrust * ((7864 * (c, s)) >> 16)
//   vel'   = (clamp(vel + acc, -6 << 16, 6 << 16) * 252) >> 8
//   pos'   = (pos + vel') mod (800 << 16, 600 << 16)
// Sums wrap as PyTorch's int32 sums do (computed unsigned), >> is arithmetic,
// and mod is torch.remainder's floored remainder: C's % truncates, so a
// negative remainder is moved up by the divisor (and mod 256 is & 255).  An
// input element of any integer dtype is read by its low byte: the eager
// body's cast to int32 keeps those bits.
//
// Bound: device memory.  A session of P players reads 20 P bytes of state and
// P input elements and writes 20 P bytes (82 B at P = 2, one u8 a player),
// for a few dozen integer operations: far below the card's operations-per-
// byte balance.  What the design does about it:
// - every leaf is read in place: the wrapper passes each leaf's session
//   stride, so a ring slot view (stride R P 8 bytes) or a slice of the
//   window's inputs (stride d P or R P bytes) is read without a copy; only
//   the inner (P, 2) / (P) dimensions must be contiguous;
// - the new state is written once, to the three contiguous outputs the
//   wrapper allocates; nothing else touches device memory;
// - a thread a (session, player) pair: neighbouring threads read neighbouring
//   8-byte position and velocity pairs and write them the same way, so a
//   warp's loads and stores of contiguous rows are each one coalesced span;
//   a thread a session with 16-byte loads was 0.6 % slower on contiguous rows
//   and 1.4 % on a ring slot (PERF.md);
// - the 256-entry sine table is copied into shared memory by each block, so
//   lanes that look up different entries are served in one pass per bank
//   rather than serialised as a __constant__ read would be.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFp = 16;
constexpr int kRotPeriod = 256;
constexpr int kRotStep = 3;
constexpr int kAccel = 7864;  // int(0.12 * 65536)
constexpr int kMaxSpeed = 6 << kFp;
constexpr int kFrictionNum = 252;
constexpr int kWindowW = 800 << kFp;
constexpr int kWindowH = 600 << kFp;

struct Args {
  const char* pos;  // session 0's row of each leaf
  const char* vel;
  const char* rot;
  const unsigned char* inp;
  long long pos_stride;  // bytes from one session's row to the next
  long long vel_stride;
  long long rot_stride;
  long long inp_stride;
  long long inp_item;  // bytes of one input element
  int2* pos_out;       // contiguous (rows, P) pairs
  int2* vel_out;
  int* rot_out;        // contiguous (rows, P)
  const int* lut;      // 256 int32
  long long rows;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// torch.remainder of an int32 by a positive divisor
__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int friction(int v) {
  return (min(max(v, -kMaxSpeed), kMaxSpeed) * kFrictionNum) >> 8;
}

// One player's step; `bits` is the input's low byte.
__device__ __forceinline__ void step(const int* lut, int bits, int& rot, int2& vel, int2& pos) {
  const int turn = ((bits >> 3) & 1) - ((bits >> 2) & 1);
  const int thrust = (bits & 1) - ((bits >> 1) & 1);
  rot = wrap_add(rot, turn * kRotStep) & (kRotPeriod - 1);
  const int c = lut[(rot + kRotPeriod / 4) & (kRotPeriod - 1)];
  const int s = lut[rot];
  vel.x = friction(wrap_add(vel.x, thrust * ((kAccel * c) >> kFp)));
  vel.y = friction(wrap_add(vel.y, thrust * ((kAccel * s) >> kFp)));
  pos.x = floor_mod(wrap_add(pos.x, vel.x), kWindowW);
  pos.y = floor_mod(wrap_add(pos.y, vel.y), kWindowH);
}

// A thread a (session, player) pair: neighbouring threads on neighbouring
// 8-byte pairs of each leaf.
template <int P>
__global__ void __launch_bounds__(kThreads) boxgame_advance_kernel(const __grid_constant__ Args a) {
  __shared__ int lut[kRotPeriod];
  for (int i = threadIdx.x; i < kRotPeriod; i += kThreads) lut[i] = __ldg(a.lut + i);
  __syncthreads();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.rows * P) return;
  const long long r = t / P;
  const int k = (int)(t - r * P);
  int2 pos = __ldg(reinterpret_cast<const int2*>(a.pos + r * a.pos_stride) + k);
  int2 vel = __ldg(reinterpret_cast<const int2*>(a.vel + r * a.vel_stride) + k);
  int rot = __ldg(reinterpret_cast<const int*>(a.rot + r * a.rot_stride) + k);
  step(lut, __ldg(a.inp + r * a.inp_stride + k * a.inp_item), rot, vel, pos);
  a.pos_out[t] = pos;
  a.vel_out[t] = vel;
  a.rot_out[t] = rot;
}

template <int P>
void launch(const Args& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.rows * P + kThreads - 1) / kThreads);
  boxgame_advance_kernel<P><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

// The constants the kernel is compiled with, for the wrapper to hold against
// its own: rot period, fixed-point shift, rot step, accel, max speed,
// friction numerator, window width, window height.
extern "C" void ggrs_boxgame_constants(long long* out) {
  out[0] = kRotPeriod;
  out[1] = kFp;
  out[2] = kRotStep;
  out[3] = kAccel;
  out[4] = kMaxSpeed;
  out[5] = kFrictionNum;
  out[6] = kWindowW;
  out[7] = kWindowH;
}

// One BoxGame step for `rows` sessions of `players` (2, 3 or 4) players.
// pos, vel: int32 rows of (players, 2), 8-byte aligned, *_stride bytes apart;
// rot: int32 rows of (players); inp: rows of `players` elements of inp_item
// bytes, of which the low (first) byte is read; strides in bytes.  pos_out,
// vel_out, rot_out: contiguous int32 outputs, written whole.  lut: the 256
// int32 sine table on the device.  Launches on `stream`, allocates nothing,
// does not synchronise, and returns 0 or a CUDA error code (cudaGetLastError()
// after the launch); rows = 0 launches nothing.
extern "C" int ggrs_boxgame_advance(int players, long long rows, const void* pos,
                                    long long pos_stride, const void* vel,
                                    long long vel_stride, const void* rot,
                                    long long rot_stride, const void* inp,
                                    long long inp_stride, long long inp_item, void* pos_out,
                                    void* vel_out, void* rot_out, const void* lut,
                                    void* stream) {
  if (players < 2 || players > 4 || rows < 0 || inp_item < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if ((rows * players + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.pos = static_cast<const char*>(pos);
  a.vel = static_cast<const char*>(vel);
  a.rot = static_cast<const char*>(rot);
  a.inp = static_cast<const unsigned char*>(inp);
  a.pos_stride = pos_stride;
  a.vel_stride = vel_stride;
  a.rot_stride = rot_stride;
  a.inp_stride = inp_stride;
  a.inp_item = inp_item;
  a.pos_out = static_cast<int2*>(pos_out);
  a.vel_out = static_cast<int2*>(vel_out);
  a.rot_out = static_cast<int*>(rot_out);
  a.lut = static_cast<const int*>(lut);
  a.rows = rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (players) {
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    default: launch<4>(a, s); break;
  }
  return (int)cudaGetLastError();
}
