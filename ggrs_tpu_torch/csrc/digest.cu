// The 4-lane position-sensitive state digest, one row of words per session.
//
// Replaces ggrs_tpu/ops/pallas_checksum.py::_digest_kernel (launched there by
// leaf_digest_pallas).  Row r of the (rows, width) u32 word matrix gets
// exactly ops/checksum.py::lane_sums(words[r], offset): with 1-based global
// index idx = offset + c + 1 (mod 2^32) of the word w in column c,
//   lane0 = sum w
//   lane1 = sum w * idx
//   lane2 = sum w * (idx * 40503 + 1)
//   lane3 = sum rotl(w, 13) ^ (idx * 2246822519)
// all in mod-2^32 unsigned arithmetic.
//
// Bound: device memory.  Each word is read once (4 B) for about a dozen
// integer operations, far below the card's operations-per-byte balance, so
// the floor is 4 * rows * width bytes at 3.35 TB/s.  The design keeps every
// word to exactly one read from device memory: a warp owns a segment of up
// to kSegWords words of one row, its lanes read neighbouring words (one
// 128-byte transaction per warp load), fold all four lanes in registers,
// reduce them across the warp with shuffles and add the warp's four sums
// into the zeroed (rows, 4) output with one atomicAdd per lane.
//
// The TPU kernel ran its grid in order and carried the sum across grid steps
// in SMEM.  Here blocks run in no order, so nothing carries between them;
// integer atomics commute mod 2^32, which keeps the result bitwise
// deterministic without a second pass.  The same grid serves both extremes
// of the callers: 16,384 rows of 66 words (one warp per row) and one row of
// 2^26 words (16,384 segments spread over every SM).

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr long long kSegWords = 4096;
// 8 blocks of 8 warps fill one SM's 64 warp slots; 132 SMs on an H100 SXM.
// Further tasks are taken by the grid-stride loop.
constexpr long long kMaxBlocks = 132 * 8;
constexpr unsigned kPrimeA = 40503u;
constexpr unsigned kPrimeB = 2246822519u;

__global__ void __launch_bounds__(kThreads)
lane_sums_rows_kernel(const unsigned* __restrict__ words,
                      unsigned* __restrict__ out, long long rows,
                      long long width, long long segs, unsigned offset) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  const long long tasks = rows * segs;
  for (long long t = first; t < tasks; t += stride) {
    const long long r = t / segs;
    const long long c0 = (t - r * segs) * kSegWords;
    const int n = (int)min(kSegWords, width - c0);
    const unsigned* seg = words + r * width + c0;
    const unsigned idx0 = offset + (unsigned)c0 + 1u;
    unsigned s0 = 0u, s1 = 0u, s2 = 0u, s3 = 0u;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {
      const unsigned w = seg[i];
      const unsigned idx = idx0 + (unsigned)i;
      s0 += w;
      s1 += w * idx;
      s2 += w * (idx * kPrimeA + 1u);
      s3 += ((w << 13) | (w >> 19)) ^ (idx * kPrimeB);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, d);
      s1 += __shfl_down_sync(0xffffffffu, s1, d);
      s2 += __shfl_down_sync(0xffffffffu, s2, d);
      s3 += __shfl_down_sync(0xffffffffu, s3, d);
    }
    if (lane == 0) {
      unsigned* o = out + r * 4;
      atomicAdd(o + 0, s0);
      atomicAdd(o + 1, s1);
      atomicAdd(o + 2, s2);
      atomicAdd(o + 3, s3);
    }
  }
}

}  // namespace

// words: (rows, width) u32, row-major and contiguous; out: (rows, 4) u32,
// zeroed by the caller.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int ggrs_lane_sums_rows(const void* words, void* out, long long rows,
                                   long long width, unsigned offset,
                                   void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  const long long segs = (width + kSegWords - 1) / kSegWords;
  long long blocks = (rows * segs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lane_sums_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned*>(words), static_cast<unsigned*>(out), rows,
      width, segs, offset);
  return (int)cudaGetLastError();
}
