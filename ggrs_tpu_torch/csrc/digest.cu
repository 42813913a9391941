// The 4-lane position-sensitive state digest, one launch for a whole batch of
// states, read straight from their leaves.
//
// Replaces ggrs_tpu/ops/pallas_checksum.py::_digest_kernel (launched there by
// leaf_digest_pallas), together with the packing, concatenation and salt mix
// that ggrs_tpu/ops/checksum.py::checksum_device runs around it.
//
// A state is a list of leaves; each leaf holds `rows` rows (one per session,
// or per (session, frame)) of `row_bytes` contiguous bytes, `row_stride`
// bytes apart.  Row r's logical word vector is the concatenation, leaf by
// leaf, of each leaf's row bytes read as little-endian u32 words and
// zero-padded to a 4-byte multiple: word k of a leaf row is bytes 4k..4k+3.
// That is exactly the JAX package's _as_u32_words for every dtype (4-byte
// types bitcast, 8-byte types low word then high, 1- and 2-byte types packed
// little-endian, bool as u8), so no leaf is widened, packed or copied first.
// With the 1-based global index idx = offset + k_global + 1 (mod 2^32) of a
// word w,
//   lane0 = sum w
//   lane1 = sum w * idx
//   lane2 = sum w * (idx * 40503 + 1)
//   lane3 = sum rotl(w, 13) ^ (idx * 2246822519)
// all mod 2^32.  The salted digest is acc = mix + lanes; acc ^ (acc >> 15),
// with mix = structure salt * 2654435761, a host constant per pytree
// structure.  The raw mode (lane_sums_rows) writes the lanes themselves.
//
// Bound: device memory.  Each byte is read once for about a dozen integer
// operations per word, far below the card's operations-per-byte balance, so
// the floor is the leaves' bytes plus 16 B of output per row at 3.35 TB/s.
// What the design does about it:
// - Every byte is read from device memory once, in place, and no leaf is
//   widened or copied in device memory first.
// - Rows up to kGroupMaxWords words (game states: ChipVM's 261 bytes in
//   three leaves, BoxGame's 40) go in tiles of blockDim / g rows.  The block
//   copies a tile of every leaf into shared memory with cp.async: a leaf
//   whose rows lie back to back (a contiguous leaf, the stacked resim window)
//   as one span by all threads, any other leaf (a ring slot view) row by
//   row; 16-byte copies from the first 16-byte boundary on, 4-byte copies for
//   the head and tail.  All of a tile's loads are in flight at once, whatever
//   the number of leaves and their alignment.  A leaf row that starts off a
//   4-byte boundary (ChipVM's 1-byte `pc`, a u8 leaf of 3 bytes a row) is
//   copied as the aligned words that cover it and its words are cut out with
//   funnel shifts; an aligned word that holds a byte of the tensor never
//   crosses a page or one of the caching allocator's 512-byte blocks, so
//   reading it cannot fault, and the bytes outside the row are masked off.
//   Two tile stages per block: the next tile's copies fly while g lanes a
//   row (a power of two up to a warp, sized to the row) fold this one from
//   shared memory -- 16 bytes a read where the row is 16-byte aligned --
//   reduce it with shuffles and write its final 16 bytes.  No atomics, no
//   zeroed output, no second pass.
// - Longer rows: a block per 64 KiB segment, four independent 16-byte loads
//   per thread in flight per step, partial lanes to scratch, and a second
//   small kernel (a block per row) adds a row's segments.  Every lane is a
//   commutative sum mod 2^32, so any order is bitwise deterministic.
// - The grid is sized from the tile (or segment) count and capped at one
//   resident wave (SM count times the blocks an SM holds); blocks stride
//   over the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kGroupMaxWords = 1024;
constexpr long long kSegWords = 16384;
constexpr unsigned kPrimeA = 40503u;
constexpr unsigned kPrimeB = 2246822519u;

struct Leaf {
  long long ptr;         // address of row 0's first byte
  long long row_stride;  // bytes from one row to the next
  long long row_bytes;   // bytes of one row (contiguous)
  long long word_off;    // index of the leaf's first word in the row's vector
  long long tile_off;    // words: the leaf's region in a tile stage
  long long slot_words;  // words per row slot; 0: a tile's rows are one span
};

// Passed by value as a launch parameter (about 1.6 KB of the 4 KB allowed).
struct Table {
  Leaf leaf[kMaxLeaves];
  long long rows;
  long long width;       // words per row, over all leaves
  long long segs;        // 64 KiB segments per row (segment kernel only)
  long long tile_words;  // words of one tile stage (a multiple of 4)
  int count;
  int raw;
  unsigned offset;
  unsigned mix[4];
};

struct Lanes {
  unsigned s0, s1, s2, s3;
};

__device__ __forceinline__ void fold(Lanes& a, unsigned w, unsigned idx) {
  a.s0 += w;
  a.s1 += w * idx;
  a.s2 += w * (idx * kPrimeA + 1u);
  a.s3 += __funnelshift_l(w, w, 13) ^ (idx * kPrimeB);
}

__device__ __forceinline__ void fold4(Lanes& a, uint4 v, unsigned idx) {
  fold(a, v.x, idx);
  fold(a, v.y, idx + 1u);
  fold(a, v.z, idx + 2u);
  fold(a, v.w, idx + 3u);
}

// word k of a row of n bytes at p, byte by byte, zero past the row's end
__device__ __forceinline__ unsigned word_bytes(const unsigned char* p, long long n,
                                               long long k) {
  unsigned w = 0u;
  const long long b = 4 * k;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (b + j < n) w |= (unsigned)__ldg(p + b + j) << (8 * j);
  return w;
}

// Fold words [k0, k1) of one leaf row (n bytes at p) into `a`, this thread
// taking words t, t + g, ... of the range.  idx0 is the global index of the
// row's word 0 of this leaf.
__device__ __forceinline__ void fold_range(const unsigned char* p, long long n,
                                           long long k0, long long k1,
                                           unsigned idx0, int t, int g, Lanes& a) {
  if ((reinterpret_cast<uintptr_t>(p) & 3u) != 0u) {
    for (long long k = k0 + t; k < k1; k += g) fold(a, word_bytes(p, n, k), idx0 + (unsigned)k);
    return;
  }
  const unsigned* pw = reinterpret_cast<const unsigned*>(p);
  const long long whole = n >> 2;  // words lying wholly inside the row
  // [k0, kb): head words before the first 16-byte boundary
  long long kb = k0 + (long long)(((16u - (reinterpret_cast<uintptr_t>(pw + k0) & 15u)) & 15u) >> 2);
  if (kb > k1) kb = k1;
  const long long lim = k1 < whole ? k1 : whole;
  const int chunks = lim > kb ? (int)((lim - kb) >> 2) : 0;
  const long long ke = kb + 4LL * chunks;  // [kb, ke): 16-byte chunks
  for (long long k = k0 + t; k < kb; k += g)
    fold(a, k < whole ? __ldg(pw + k) : word_bytes(p, n, k), idx0 + (unsigned)k);
  const uint4* pv = reinterpret_cast<const uint4*>(pw + kb);
  const unsigned ib = idx0 + (unsigned)kb;
  int c = t;
  for (; c + 3 * g < chunks; c += 4 * g) {
    const uint4 v0 = __ldg(pv + c);
    const uint4 v1 = __ldg(pv + c + g);
    const uint4 v2 = __ldg(pv + c + 2 * g);
    const uint4 v3 = __ldg(pv + c + 3 * g);
    fold4(a, v0, ib + 4u * (unsigned)c);
    fold4(a, v1, ib + 4u * (unsigned)(c + g));
    fold4(a, v2, ib + 4u * (unsigned)(c + 2 * g));
    fold4(a, v3, ib + 4u * (unsigned)(c + 3 * g));
  }
  for (; c < chunks; c += g) fold4(a, __ldg(pv + c), ib + 4u * (unsigned)c);
  for (long long k = ke + t; k < k1; k += g)
    fold(a, k < whole ? __ldg(pw + k) : word_bytes(p, n, k), idx0 + (unsigned)k);
}

__device__ __forceinline__ const unsigned char* row_ptr(const Leaf& l, long long r) {
  return reinterpret_cast<const unsigned char*>(l.ptr + r * l.row_stride);
}

__device__ __forceinline__ unsigned leaf_idx0(const Table& tab, const Leaf& l) {
  return tab.offset + (unsigned)l.word_off + 1u;
}

__device__ __forceinline__ void write_out(const Table& tab, unsigned* out, long long r,
                                          Lanes a) {
  if (!tab.raw) {
    a.s0 += tab.mix[0];
    a.s1 += tab.mix[1];
    a.s2 += tab.mix[2];
    a.s3 += tab.mix[3];
    a.s0 ^= a.s0 >> 15;
    a.s1 ^= a.s1 >> 15;
    a.s2 ^= a.s2 >> 15;
    a.s3 ^= a.s3 >> 15;
  }
  reinterpret_cast<uint4*>(out)[r] = make_uint4(a.s0, a.s1, a.s2, a.s3);
}

__device__ __forceinline__ void shfl_add(Lanes& a, int d) {
  a.s0 += __shfl_xor_sync(0xffffffffu, a.s0, d);
  a.s1 += __shfl_xor_sync(0xffffffffu, a.s1, d);
  a.s2 += __shfl_xor_sync(0xffffffffu, a.s2, d);
  a.s3 += __shfl_xor_sync(0xffffffffu, a.s3, d);
}

// Sum of `a` over the block, valid in thread 0.  Ends with a barrier, so the
// shared scratch may be reused right after.
__device__ __forceinline__ Lanes block_sum(Lanes a) {
  __shared__ Lanes part[kWarps];
  for (int d = 16; d > 0; d >>= 1) shfl_add(a, d);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = (threadIdx.x < kWarps) ? part[threadIdx.x] : Lanes{0u, 0u, 0u, 0u};
    for (int d = kWarps / 2; d > 0; d >>= 1) shfl_add(a, d);
  }
  __syncthreads();
  return a;
}

__device__ __forceinline__ void cp_async4(unsigned* dst, uintptr_t src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned* dst, uintptr_t src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Threads t, t + stride, ... start copying the n bytes at p, as the aligned
// words that cover them, into `region`: the word at a = p & ~3 lands at
// region + ((a >> 2) & 3), so that region and device memory agree modulo 16
// bytes and the body moves 16 bytes a copy.  The bytes then start at byte
// (p & 15) of the region.
__device__ __forceinline__ void copy_span(unsigned* region, uintptr_t p, long long n, int t,
                                          int stride) {
  const uintptr_t a = p & ~(uintptr_t)3;
  const long long words = ((long long)(p & 3u) + n + 3) >> 2;
  unsigned* dst = region + ((a >> 2) & 3u);
  long long head = (long long)(((16u - (a & 15u)) & 15u) >> 2);
  if (head > words) head = words;
  const long long chunks = (words - head) >> 2;
  for (long long j = t; j < head; j += stride) cp_async4(dst + j, a + 4 * j);
  for (long long c = t; c < chunks; c += stride)
    cp_async16(dst + head + 4 * c, a + 4 * head + 16 * c);
  for (long long j = head + 4 * chunks + t; j < words; j += stride) cp_async4(dst + j, a + 4 * j);
}

// The block starts copying the rows r0 .. r0 + nrows - 1 of every leaf into
// the tile stage: a leaf whose rows lie back to back as one span with all
// threads, any other leaf row by row, g lanes (one group) a row.
__device__ __forceinline__ void stage_tile(const Table& tab, long long r0, int nrows,
                                           unsigned* stage, int g) {
  const int grp = threadIdx.x / g, t = threadIdx.x & (g - 1);
  for (int i = 0; i < tab.count; ++i) {
    const Leaf& l = tab.leaf[i];
    if (l.slot_words == 0)
      copy_span(stage + l.tile_off, (uintptr_t)(l.ptr + r0 * l.row_stride), nrows * l.row_bytes,
                threadIdx.x, blockDim.x);
    else if (grp < nrows)
      copy_span(stage + l.tile_off + grp * l.slot_words,
                (uintptr_t)(l.ptr + (r0 + grp) * l.row_stride), l.row_bytes, t, g);
  }
}

// The low `bytes` bytes of a word (all of it from 4 on, none from 0 down).
__device__ __forceinline__ unsigned low_bytes(int bytes) {
  return bytes >= 4 ? 0xffffffffu : bytes <= 0 ? 0u : 0xffffffffu >> (8 * (4 - bytes));
}

// Lanes t, t + g, ... of a group fold the n bytes of a leaf row that start
// at byte `at` of the stage; idx0 is the global index of the row's word 0.
__device__ __forceinline__ void fold_row(const unsigned* stage, int at, int n, unsigned idx0,
                                         int t, int g, Lanes& acc) {
  const int nw = (n + 3) >> 2;
  if ((at & 15) == 0) {
    // 16-byte aligned: lane t folds 4-word pieces t, t + g, ... read from
    // the stage 16 bytes at a time; the index terms step 4g words a turn
    const uint4* src = reinterpret_cast<const uint4*>(stage) + (at >> 4);
    const int whole = n >> 4;  // pieces wholly inside the row
    unsigned idx = idx0 + 4u * (unsigned)t;
    unsigned ka = idx * kPrimeA + 1u, kb = idx * kPrimeB;
    const unsigned di = 4u * (unsigned)g;
    int c = t;
#pragma unroll 4
    for (; c < whole; c += g) {
      const uint4 v = src[c];
      // with sum = x + y + z + w and ramp = y + 2z + 3w:
      //   lane1 terms = idx * sum + ramp, lane2 terms = ka * sum + A * ramp
      const unsigned sum = v.x + v.y + v.z + v.w;
      const unsigned ramp = v.y + 2u * v.z + 3u * v.w;
      acc.s0 += sum;
      acc.s1 += idx * sum + ramp;
      acc.s2 += ka * sum + kPrimeA * ramp;
      acc.s3 += (__funnelshift_l(v.x, v.x, 13) ^ kb) + (__funnelshift_l(v.y, v.y, 13) ^ (kb + kPrimeB)) +
                (__funnelshift_l(v.z, v.z, 13) ^ (kb + 2u * kPrimeB)) +
                (__funnelshift_l(v.w, v.w, 13) ^ (kb + 3u * kPrimeB));
      idx += di;
      ka += di * kPrimeA;
      kb += di * kPrimeB;
    }
    const int rest = n - 16 * whole;
    if (rest > 0 && c == whole) {
      // the row's last, partial piece: only its words that hold row bytes
      const uint4 v = src[whole];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * j < rest) fold(acc, w[j] & low_bytes(rest - 4 * j), idx + (unsigned)j);
    }
    return;
  }
  // any other start: word by word, cut out of the covering aligned words
  // (the stage holds a word past the last one)
  const unsigned shift = 8u * (unsigned)(at & 3);
  const unsigned* src = stage + (at >> 2);
  unsigned idx = idx0 + (unsigned)t;
  unsigned ka = idx * kPrimeA + 1u, kb = idx * kPrimeB;
  const unsigned da = (unsigned)g * kPrimeA, db = (unsigned)g * kPrimeB;
  for (int k = t; k < nw; k += g) {
    const unsigned w = __funnelshift_r(src[k], src[k + 1], shift) & low_bytes(n - 4 * k);
    acc.s0 += w;
    acc.s1 += w * idx;
    acc.s2 += w * ka;
    acc.s3 += __funnelshift_l(w, w, 13) ^ kb;
    idx += (unsigned)g;
    ka += da;
    kb += db;
  }
}

// Rows of up to kGroupMaxWords words, in tiles of blockDim.x / g rows: the
// block stages a tile's leaves in shared memory (two tile stages, so the
// next tile's copies fly while this one is folded), then group `grp` of g
// lanes (g a power of two, at most 32) folds row grp of the tile, reduces it
// with shuffles and writes its 16 bytes.  Blocks stride over the tiles.
__global__ void __launch_bounds__(kThreads)
state_digest_rows_kernel(const __grid_constant__ Table tab, unsigned* __restrict__ out, int g) {
  extern __shared__ uint4 smem[];
  const int grp = threadIdx.x / g, t = threadIdx.x & (g - 1);
  const int tile_rows = blockDim.x / g;
  const long long tiles = (tab.rows + tile_rows - 1) / tile_rows;
  unsigned* const stages = reinterpret_cast<unsigned*>(smem);
  auto rows_of = [&](long long tile) {
    const long long left = tab.rows - tile * tile_rows;
    return (int)(left < tile_rows ? left : tile_rows);
  };
  long long tile = blockIdx.x;
  if (tile < tiles) stage_tile(tab, tile * tile_rows, rows_of(tile), stages, g);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const unsigned* cur = stages + (it & 1) * tab.tile_words;
    const long long next = tile + gridDim.x;
    if (next < tiles)
      stage_tile(tab, next * tile_rows, rows_of(next), stages + ((it + 1) & 1) * tab.tile_words, g);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const long long r0 = tile * tile_rows, r = r0 + grp;
    Lanes a{0u, 0u, 0u, 0u};
    if (r < tab.rows) {
      for (int i = 0; i < tab.count; ++i) {
        const Leaf& l = tab.leaf[i];
        // where the row's first byte sits in the stage (see copy_span)
        const uintptr_t p = (uintptr_t)(l.ptr + r * l.row_stride);
        const int at = l.slot_words == 0
            ? (int)(4 * l.tile_off + ((l.ptr + r0 * l.row_stride) & 15) + grp * l.row_bytes)
            : (int)(4 * (l.tile_off + grp * l.slot_words) + (p & 15u));
        fold_row(cur, at, (int)l.row_bytes, leaf_idx0(tab, l), t, g, a);
      }
    }
    for (int d = g >> 1; d > 0; d >>= 1) shfl_add(a, d);
    if (t == 0 && r < tab.rows) write_out(tab, out, r, a);
    __syncthreads();  // the whole tile is folded before its stage is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Longer rows: a block per (row, kSegWords-word segment).  With one segment
// per row the block writes the digest; otherwise its partial lanes go to
// `partial` for state_digest_finish_kernel.
__global__ void __launch_bounds__(kThreads)
state_digest_segments_kernel(const __grid_constant__ Table tab, unsigned* __restrict__ out,
                             unsigned* __restrict__ partial) {
  const long long tasks = tab.rows * tab.segs;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long r = task / tab.segs;
    const long long w0 = (task - r * tab.segs) * kSegWords;
    const long long w1 = w0 + kSegWords < tab.width ? w0 + kSegWords : tab.width;
    Lanes a{0u, 0u, 0u, 0u};
    for (int i = 0; i < tab.count; ++i) {
      const Leaf& l = tab.leaf[i];
      const long long nw = (l.row_bytes + 3) >> 2;
      const long long lo = w0 > l.word_off ? w0 : l.word_off;
      const long long hi = w1 < l.word_off + nw ? w1 : l.word_off + nw;
      if (lo < hi)
        fold_range(row_ptr(l, r), l.row_bytes, lo - l.word_off, hi - l.word_off,
                   leaf_idx0(tab, l), threadIdx.x, kThreads, a);
    }
    a = block_sum(a);
    if (threadIdx.x == 0) {
      if (tab.segs == 1)
        write_out(tab, out, r, a);
      else
        reinterpret_cast<uint4*>(partial)[task] = make_uint4(a.s0, a.s1, a.s2, a.s3);
    }
  }
}

// A block per row: the sum of the row's segment partials, then the epilogue.
__global__ void __launch_bounds__(kThreads)
state_digest_finish_kernel(const __grid_constant__ Table tab, const unsigned* __restrict__ partial,
                           unsigned* __restrict__ out) {
  const long long r = blockIdx.x;
  const uint4* p = reinterpret_cast<const uint4*>(partial) + r * tab.segs;
  Lanes a{0u, 0u, 0u, 0u};
  for (long long s = threadIdx.x; s < tab.segs; s += kThreads) {
    const uint4 v = p[s];
    a.s0 += v.x;
    a.s1 += v.y;
    a.s2 += v.z;
    a.s3 += v.w;
  }
  a = block_sum(a);
  if (threadIdx.x == 0) write_out(tab, out, r, a);
}

// Per device: SM count, resident blocks per SM of the segment kernel, and of
// the rows kernel at the last dynamic shared memory size asked for.
struct Occupancy {
  int sms = 0, seg_blocks = 0;
  long long rows_smem = -1;
  int rows_blocks = 0;
};
constexpr int kMaxDevices = 64;
constexpr int kMaxDynamicSmem = 227 * 1024;
Occupancy g_occ[kMaxDevices];

// The device's entry, filled at its first use; rows_blocks is brought up to
// date for `rows_smem` bytes of dynamic shared memory per block.
int occupancy(long long rows_smem, Occupancy* o) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Occupancy& c = g_occ[dev];
  if (c.sms == 0) {
    Occupancy n;
    e = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(state_digest_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(state_digest_rows_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n.seg_blocks,
                                                        state_digest_segments_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    c = n;
  }
  if (rows_smem >= 0 && rows_smem != c.rows_smem) {
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, state_digest_rows_kernel,
                                                      kThreads, (size_t)rows_smem);
    if (e != cudaSuccess) return (int)e;
    c.rows_smem = rows_smem;
    c.rows_blocks = blocks;
  }
  *o = c;
  return 0;
}

// Lays out a tile stage of `tile_rows` rows: each leaf's region, as one span
// where its rows lie back to back, else as a slot per row.  Each region has
// room for the alignment offset (up to 3 words), the covering words, the
// word past them that the funnel shift reads and the rest of a last 16-byte
// piece, and starts on a 16-byte boundary.  Returns the stage's words.
long long tile_layout(Table* tab, long long tile_rows) {
  long long words = 0;
  for (int i = 0; i < tab->count; ++i) {
    Leaf& l = tab->leaf[i];
    l.tile_off = words;
    if (l.row_stride == l.row_bytes) {
      l.slot_words = 0;
      words += ((tile_rows * l.row_bytes + 3) / 4 + 8 + 3) & ~3LL;
    } else {
      l.slot_words = ((l.row_bytes + 3) / 4 + 4 + 3) & ~3LL;
      words += tile_rows * l.slot_words;
    }
  }
  return words;
}

long long segments(long long width) {
  return width > kGroupMaxWords ? (width + kSegWords - 1) / kSegWords : 0;
}

}  // namespace

// The limits the wrapper must respect: out[0] the most leaves in a table,
// out[1] the widest row (words) of the group kernel, out[2] the segment
// length (words) of the segment kernel.
extern "C" void ggrs_digest_limits(long long* out) {
  out[0] = kMaxLeaves;
  out[1] = kGroupMaxWords;
  out[2] = kSegWords;
}

// leaves: `count` entries of 4 int64 each (pointer, row stride in bytes,
// bytes per row, first word index), read on the host and passed to the kernel
// by value; leaves with empty rows are left out, so `count` may be 0.  out: (rows, 4) u32, written whole (need not be zeroed).
// scratch: rows * segs * 4 u32 where width > kGroupMaxWords and segs =
// ceil(width / kSegWords) > 1, else unused.  raw = 1 writes the lanes; raw = 0
// the salted digest with mix m0..m3.  Launches on `stream`, does not
// synchronise, and returns 0 or a CUDA error code (cudaGetLastError() after
// the launches).
extern "C" int ggrs_state_digest(const long long* leaves, int count, long long rows,
                                 long long width, int raw, unsigned m0, unsigned m1,
                                 unsigned m2, unsigned m3, unsigned offset, void* out,
                                 void* scratch, void* stream) {
  if (count < 0 || count > kMaxLeaves || rows < 0 || width < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  Table tab;
  for (int i = 0; i < count; ++i) {
    Leaf& l = tab.leaf[i];
    l.ptr = leaves[4 * i + 0];
    l.row_stride = leaves[4 * i + 1];
    l.row_bytes = leaves[4 * i + 2];
    l.word_off = leaves[4 * i + 3];
  }
  for (int i = count; i < kMaxLeaves; ++i) tab.leaf[i] = Leaf{0, 0, 0, 0, 0, 0};
  tab.rows = rows;
  tab.width = width;
  tab.segs = segments(width);
  tab.count = count;
  tab.raw = raw;
  tab.offset = offset;
  tab.mix[0] = m0;
  tab.mix[1] = m1;
  tab.mix[2] = m2;
  tab.mix[3] = m3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* o = static_cast<unsigned*>(out);
  Occupancy occ;
  int err;
  if (tab.segs == 0) {
    // up to 64 words a lane: a row's fixed costs (table reads, addresses,
    // the shuffles) are paid by few lanes
    int g = 1;
    while (g < 32 && 64LL * g < width) g <<= 1;
    long long smem;
    for (;; g <<= 1) {
      tab.tile_words = tile_layout(&tab, kThreads / g);
      smem = 2 * tab.tile_words * 4;
      // wider groups (shorter tiles) for rows of many small leaves, so that
      // two blocks fit an SM
      if (smem <= kMaxDynamicSmem / 2 || g == 32) break;
    }
    err = occupancy(smem, &occ);
    if (err != 0) return err;
    if (occ.rows_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    const long long tile_rows = kThreads / g;
    long long blocks = (rows + tile_rows - 1) / tile_rows;
    const long long wave = (long long)occ.sms * occ.rows_blocks;
    if (blocks > wave) blocks = wave;
    state_digest_rows_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(tab, o, g);
  } else {
    err = occupancy(-1, &occ);
    if (err != 0) return err;
    if (occ.seg_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    if (tab.segs > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
    long long blocks = rows * tab.segs;
    const long long wave = (long long)occ.sms * occ.seg_blocks;
    if (blocks > wave) blocks = wave;
    unsigned* part = static_cast<unsigned*>(scratch);
    state_digest_segments_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(tab, o, part);
    if (tab.segs > 1) {
      err = (int)cudaGetLastError();
      if (err != 0) return err;
      state_digest_finish_kernel<<<(unsigned)rows, kThreads, 0, s>>>(tab, part, o);
    }
  }
  return (int)cudaGetLastError();
}
