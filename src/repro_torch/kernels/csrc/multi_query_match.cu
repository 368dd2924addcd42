// AMPER-fr m-range TCAM match over the flat priority table, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/tcam_match.py:73
// (multi_query_kernel, called through multi_query_match at :93).
// Computes, for n rows and m inclusive ranges [lo_i, hi_i]:
//   sel[r]    = valid[r] && OR_i (lo_i <= pq[r] <= hi_i)
//   counts[i] = #{ r : valid[r] && lo_i <= pq[r] <= hi_i }
//
// Bound: bytes.  Each row is read once (4 B of pq, 1 B of valid) and its
// selection bit written once (1 B): 6 B a row, about 1.8 us at n = 1e6 on
// an H100 SXM (3.35 TB/s).  The range tests come next: m tests a row, 2e7
// at n = 1e6 and m = 20, which as integer compares on the half-rate
// integer pipe take longer than the bytes; here each is four FP32
// instructions (onepass.cuh's three, and one more that adds it to its
// row's flag), about 2.5 us of issue on 132 SMs.
//
// Design: one launch, no memset.
//   * A grid of one wave (the blocks that fit on the card at once, from
//     the occupancy the compiled kernel allows) walks the 1024-row tiles
//     of onepass.cuh: 128 threads, 8 rows a thread (measured faster at
//     n = 1e6 than 256 threads or 4 or 16 rows), both int4 + uchar4
//     loads in flight before the first test and the next tile's loads in
//     flight while this one is tested; the ragged tail masked there.  sel
//     goes out as one uchar4 per 4 rows.
//   * A thread keeps its per-range counts in registers across all its
//     rows (the kernel is compiled for m rounded up to a multiple of 8,
//     so they index statically; no instance spills), and a tile waiting
//     in registers stays packed as it was loaded (int4 of pq, 32-bit
//     words of valid flags).  Then one warp reduction per range, and the
//     warps summed in shared memory.
//   * The block adds its partial count of range i to a 64-bit word of
//     the wrapper's scratch, acc[i] += (1 << 40) + partial: the high bits
//     count the blocks that have added, the low 40 bits sum the counts.
//     The add that completes the count gets back the sum of every other
//     block's partial, so that block writes counts[i] and puts acc[i]
//     back to zero.  One atomic round trip a block, m threads at once,
//     carrying its data: no fence, no ticket, no second pass over
//     per-block partials by a last block (that tail measured slower at a
//     250k shard) and no fill of counts.
// Integer sums are exact, so counts do not depend on block order (the
// TPU kernel relied on its sequential grid instead).  Flag reuse: the
// words are zero when the scratch is made and back to zero when a call
// ends (each reset by the block that completed it, after every block has
// added), so a call queued behind it on the stream finds them zero.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "onepass.cuh"

namespace {

using amper::kFull;
using amper::kMaxRanges;

constexpr int kThreads = 128;                 // threads of a block
constexpr int kLoads = 2;                     // int4 loads of pq a thread
constexpr int kRows = 4 * kThreads * kLoads;  // rows of a tile (1024)
constexpr int kRowsPerThread = 4 * kLoads;    // per tile
constexpr int kWarps = kThreads / 32;

// Tests one tile's rows against the ranges: sel flags s[k], and adds the
// hits to the per-range counts c[i] (the float test when FP, see
// onepass.cuh).
template <bool FP, int MB>
__device__ __forceinline__ void test_rows(const int32_t (&p)[kRowsPerThread],
                                          const bool (&v)[kRowsPerThread],
                                          onepass::Window win, int m,
                                          const int32_t* s_lo,
                                          const int32_t* s_hi,
                                          const float* s_l, const float* s_h,
                                          bool (&s)[kRowsPerThread],
                                          float (&c)[MB]) {
  if (FP) {
    float x[kRowsPerThread], hits[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      x[k] = onepass::row_key(p[k], v[k], win);
      hits[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (i < m) {
        const float l = s_l[i], h = s_h[i];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const float t1 = onepass::sat_add(x[k], l);
          const float t2 = onepass::sat_sub(h, x[k]);
          c[i] = fmaf(t1, t2, c[i]);
          hits[k] = fmaf(t1, t2, hits[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) s[k] = hits[k] > 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) s[k] = false;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (i < m) {
        const int32_t a = s_lo[i], b = s_hi[i];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const bool h = v[k] & (p[k] >= a) & (p[k] <= b);
          s[k] |= h;
          c[i] += h ? 1.0f : 0.0f;
        }
      }
    }
  }
}

__device__ __forceinline__ void store_sel(uint8_t* __restrict__ sel,
                                          long long n, long long t,
                                          const bool (&s)[kRowsPerThread]) {
#pragma unroll
  for (int l = 0; l < kLoads; ++l)
    amper::store4(sel, n, t * kRows + 4LL * kThreads * l + 4 * threadIdx.x,
                  &s[4 * l]);
}

// Walks the block's tiles (blockIdx.x < ntiles, + gridDim.x, ...) from
// the first one's rows in cur, the next tile's loads in flight while one
// is tested; counts stay in c.  Returns the last tile, whose flags are
// left in s, not stored.
template <bool FP, int MB>
__device__ __forceinline__ long long walk_tiles(
    const int32_t* __restrict__ pq, const uint8_t* __restrict__ valid,
    long long n, long long ntiles, onepass::Rows<kLoads> cur,
    onepass::Window win, int m, const int32_t* s_lo, const int32_t* s_hi,
    const float* s_l, const float* s_h, uint8_t* __restrict__ sel,
    bool (&s)[kRowsPerThread], float (&c)[MB]) {
  for (long long t = blockIdx.x;; t += gridDim.x) {
    const long long next = t + gridDim.x;
    onepass::Rows<kLoads> nxt;
    if (next < ntiles)
      nxt = onepass::load_rows<kThreads, kLoads>(pq, valid, n, next * kRows);
    int32_t p[kRowsPerThread];
    bool v[kRowsPerThread];
    onepass::unpack(cur, p, v);
    test_rows<FP, MB>(p, v, win, m, s_lo, s_hi, s_l, s_h, s, c);
    if (next >= ntiles) return t;
    store_sel(sel, n, t, s);
    cur = nxt;
  }
}

// MB: the counters a thread keeps (m rounded up to a multiple of 8).
template <int MB>
__global__ void __launch_bounds__(kThreads)
    multi_query_match_kernel(const int32_t* __restrict__ pq,
                             const uint8_t* __restrict__ valid, long long n,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int m,
                             uint8_t* __restrict__ sel,
                             int32_t* __restrict__ counts,
                             unsigned long long* __restrict__ acc,
                             long long ntiles) {
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  __shared__ float s_l[kMaxRanges], s_h[kMaxRanges];
  __shared__ int s_warp[kWarps][MB];
  __shared__ onepass::Window s_win;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool has_tile = blockIdx.x < ntiles;  // false only when n = 0
  onepass::Rows<kLoads> cur;
  if (has_tile)  // in flight while the ranges are prepared
    cur = onepass::load_rows<kThreads, kLoads>(
        pq, valid, n, static_cast<long long>(blockIdx.x) * kRows);
  if (warp == 0) {
    const onepass::Window w = onepass::prepare_ranges(
        onepass::load_lane_ranges(lo, hi, m), m, s_lo, s_hi, s_l, s_h);
    if (lane == 0) s_win = w;
  }
  __syncthreads();
  const onepass::Window win = s_win;

  float c[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) c[i] = 0.0f;
  bool s[kRowsPerThread];
  long long last_tile = -1;
  if (has_tile)
    last_tile = win.fp
        ? walk_tiles<true, MB>(pq, valid, n, ntiles, cur, win, m, s_lo,
                               s_hi, s_l, s_h, sel, s, c)
        : walk_tiles<false, MB>(pq, valid, n, ntiles, cur, win, m, s_lo,
                                s_hi, s_l, s_h, sel, s, c);

  unsigned r[MB];  // all the warp's reductions in flight at once
#pragma unroll
  for (int i = 0; i < MB; ++i)
    if (i < m) r[i] = __reduce_add_sync(kFull, static_cast<unsigned>(c[i]));
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < MB; ++i)
      if (i < m) s_warp[warp][i] = static_cast<int>(r[i]);
  }
  __syncthreads();
  // The block's partial count of range i goes into acc[i] with one
  // atomic add of (1 << 40) + partial: the high bits count the blocks
  // that have added, the low 40 the running sum.  The add that completes
  // the count knows the range's total: that block writes counts[i] and
  // puts acc[i] back to zero for the next call.
  if (tid < m) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_warp[w][tid];
    const unsigned long long old =
        atomicAdd(&acc[tid], (1ull << 40) | static_cast<unsigned>(sum));
    if ((old >> 40) == gridDim.x - 1) {
      counts[tid] = static_cast<int32_t>((old + sum) & ((1ull << 40) - 1));
      acc[tid] = 0;
    }
  }
  if (last_tile >= 0) store_sel(sel, n, last_tile, s);
}

// The blocks of one wave of multi_query_match_kernel<MB> on `sms` SMs.
template <int MB>
int wave(int sms) {
  static int per_sm = 0;  // the compiled kernel's, found once
  if (per_sm == 0) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, multi_query_match_kernel<MB>, kThreads, 0) != cudaSuccess ||
        b < 1)
      b = 1;
    per_sm = b;
  }
  return per_sm * sms;
}

template <int MB>
void launch(int sms, cudaStream_t s, const void* pq, const void* valid,
            long long n, const void* lo, const void* hi, int m, void* sel,
            void* counts, unsigned long long* acc) {
  const long long ntiles = (n + kRows - 1) / kRows;
  const int cap = wave<MB>(sms);
  const int blocks = static_cast<int>(
      ntiles < 1 ? 1 : ntiles < cap ? ntiles : cap);
  multi_query_match_kernel<MB><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(pq), static_cast<const uint8_t*>(valid), n,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi), m,
      static_cast<uint8_t*>(sel), static_cast<int32_t*>(counts), acc,
      ntiles);
}

}  // namespace

// scratch: 64 uint64 words, zeroed when first made and left zeroed by
// every call.  pq must be 16-byte and valid and sel 4-byte aligned
// (common.cuh).  One launch on `stream`, also for n = 0 (counts are then
// zeros); returns its error, or 0.
extern "C" int multi_query_match_launch(
    const void* pq, const void* valid, long long n, const void* lo,
    const void* hi, int m, void* sel, void* counts, void* scratch, int sms,
    void* stream) {
  if (m < 1 || m > kMaxRanges || n < 0 || sms < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<unsigned long long*>(scratch);
  switch ((m + 7) / 8) {
    case 1: launch<8>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    case 2: launch<16>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    case 3: launch<24>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    case 4: launch<32>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    case 5: launch<40>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    case 6: launch<48>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    case 7: launch<56>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc); break;
    default: launch<64>(sms, s, pq, valid, n, lo, hi, m, sel, counts, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* multi_query_match_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
