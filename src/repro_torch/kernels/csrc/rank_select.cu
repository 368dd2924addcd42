// The flat index of each rank-th member of the m-range match, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/amper_sample.py:276
// (rank_select_kernel, called through rank_select at :332).  Same
// function as the port's kernels/ref.py::rank_select_ref:
//
//   sel[r]  = valid[r] && OR_i (lo_i <= pq[r] <= hi_i)
//   count   = #members
//   idx[j]  = 0 <= rank[j] < count ? flat index of the rank[j]-th member
//                                    (index order) : 0
//
// It is the per-shard pick of the sharded AMPER-fr draw: each shard turns
// the draws it owns into local indices without compacting its CSP.
//
// Bound: bytes.  Every row is read once (4 B of pq + 1 B of valid), and
// each rank read and each index written once: about 1.5 us at n = 1e6
// and 0.37 us for one 250,000-row shard on an H100 SXM (3.35 TB/s).  At
// these sizes what remains is the chain of dependent memory round trips
// of a block (ticket, rows, look-back, ranks) and the range tests.
//
// Design: the TPU kernel carried the running member count across its
// sequential grid in SMEM and gathered with one-hot f32 matmuls.  Here it
// is one launch, one block per tile, built from onepass.cuh.  A tile is
// 1024 rows (128 threads, 8 rows each: 245 blocks for a 250k shard, the
// main path's call, and 977 at n = 1e6):
//   * the block takes its tile from an atomic ticket (the m ranges'
//     loads overlap it) and reads the tile's rows once (int4 + uchar4
//     loads); while they are in flight, one warp puts the ranges in
//     shared memory in their float form (merging them into their union
//     first, 5-6 intervals for the DQN's m = 20, measured slower at a
//     250k shard: the merge outlasts the loads);
//   * the range tests run on the FP32 pipe (onepass.cuh; the integer
//     test where the ranges span 2^24 or more), range by range over the
//     thread's rows;
//   * membership goes to shared memory as 32-bit words in index order
//     (each thread's 4-row nibbles ORed together across 8 lanes by
//     shuffles), with each word's exclusive member prefix in the tile;
//   * one warp publishes the tile's member count, finds the tile's
//     exclusive prefix by decoupled look-back (32 predecessors a round)
//     and publishes the inclusive count;
//   * each rank in [prefix, prefix + members) is resolved from shared
//     memory alone: a binary search over the word prefixes, then the set
//     bit of that rank within the word (popcounts); the tile is not read
//     again;
//   * the block of the last tile knows the total: it writes `count` and
//     zeros the ranks outside [0, count).  Every other rank is written by
//     the one block whose range holds it, so idx needs no zeroing, and
//     batch 0 still writes count.
// Block order: tiles come from the ticket, so a block only waits on
// blocks already running.  Flag reuse: the ticket and the status words
// live in the wrapper's scratch, zeroed once when made.  Nothing resets
// them, so no block waits at the end for the others: the ticket counts
// on across calls and a tile is the ticket minus `base`, the count before
// this call; every status word carries the call's `epoch`, and words of
// an earlier call read as unpublished.  The wrapper counts both on the
// host (no sync) and makes a fresh zeroed scratch when the 30-bit epoch
// would wrap, so no two calls on one scratch share an epoch, and a call
// queued behind this one on the stream (it starts only after this one has
// ended) never takes this call's words for its own.  The result is exact
// integer arithmetic, independent of block order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "onepass.cuh"

namespace {

using amper::kFull;
using amper::kMaxRanges;

constexpr int kThreads = 128;             // a block's threads
constexpr int kLoads = 2;                 // 4-row loads a thread
constexpr int kRows = 4 * kThreads * kLoads;  // tile rows: 1024

// The tile-local offset of the lr-th member (0 <= lr < members).  The
// largest word whose prefix is <= lr holds it, since empty words never
// end a run of prefixes <= lr.
template <int kWords>
__device__ __forceinline__ int resolve(const unsigned* words, const int* pre,
                                       int lr) {
  int lo = 0, hi = kWords - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= lr) lo = mid; else hi = mid - 1;
  }
  return 32 * lo + onepass::nth_set_bit(words[lo], lr - pre[lo]);
}

// The tile's membership: mem[k] for the row of p[k], v[k].
template <int R>
__device__ __forceinline__ void test_rows(const int32_t (&p)[R],
                                          const bool (&v)[R],
                                          onepass::Window win, int m,
                                          const int32_t* s_lo,
                                          const int32_t* s_hi,
                                          const float* s_l, const float* s_h,
                                          bool (&mem)[R]) {
  if (win.fp) {
    float x[R], hits[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x[k] = onepass::row_key(p[k], v[k], win);
      hits[k] = 0.0f;
    }
    for (int i = 0; i < m; ++i) {
      const float l = s_l[i], h = s_h[i];
#pragma unroll
      for (int k = 0; k < R; ++k)
        hits[k] = onepass::add_hit(x[k], l, h, hits[k]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) mem[k] = hits[k] > 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) mem[k] = false;
    for (int i = 0; i < m; ++i) {
      const int32_t a = s_lo[i], b = s_hi[i];
#pragma unroll
      for (int k = 0; k < R; ++k)
        mem[k] |= v[k] & (p[k] >= a) & (p[k] <= b);
    }
  }
}

// A block of kThreads threads over a tile of kRows rows.
__global__ void __launch_bounds__(kThreads) rank_select_kernel(
    const int32_t* __restrict__ pq, const uint8_t* __restrict__ valid,
    long long n, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, int m, const int32_t* __restrict__ rank,
    int batch, int32_t* __restrict__ idx, int32_t* __restrict__ count,
    unsigned* __restrict__ ticket, unsigned long long* __restrict__ status,
    int nblk, unsigned epoch, unsigned base) {
  constexpr int kWords = kRows / 32;  // membership words of a tile
  constexpr int kWordsPerLane = kWords / 32;
  static_assert(kWords % 32 == 0, "a warp scans the tile's words");
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  __shared__ float s_l[kMaxRanges], s_h[kMaxRanges];
  __shared__ unsigned s_words[kWords];
  __shared__ int s_pre[kWords];
  __shared__ int s_tile, s_prefix, s_members;
  __shared__ onepass::Window s_win;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(ticket, 1u) - base);
  onepass::LaneRanges ranges;  // their loads overlap the ticket's
  if (tid < 32) ranges = onepass::load_lane_ranges(lo, hi, m);
  const int r_first = tid < batch ? rank[tid] : 0;
  __syncthreads();
  const int tile = s_tile;
  const long long tile0 = static_cast<long long>(tile) * kRows;
  const onepass::Rows<kLoads> rows =
      onepass::load_rows<kThreads, kLoads>(pq, valid, n, tile0);
  if (tid < 32) {  // while the rows are in flight
    const onepass::Window w =
        onepass::prepare_ranges(ranges, m, s_lo, s_hi, s_l, s_h);
    if (tid == 0) s_win = w;
  }
  __syncthreads();
  int32_t p[4 * kLoads];
  bool v[4 * kLoads];
  onepass::unpack(rows, p, v);
  bool mem[4 * kLoads];
  test_rows<4 * kLoads>(p, v, s_win, m, s_lo, s_hi, s_l, s_h, mem);
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    unsigned nib = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      nib |= static_cast<unsigned>(mem[4 * l + k]) << k;
    // rows 4 tid .. 4 tid + 3 of this load: bits 4 (tid % 8) .. +3 of
    // word (4 kThreads l + 4 tid) / 32
    unsigned w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(kFull, w, 1);
    w |= __shfl_xor_sync(kFull, w, 2);
    w |= __shfl_xor_sync(kFull, w, 4);
    if ((lane & 7) == 0) s_words[l * (kThreads / 8) + (tid >> 3)] = w;
  }
  __syncthreads();

  if (tid < 32) {
    int c[kWordsPerLane];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      c[k] = __popc(s_words[lane * kWordsPerLane + k]);
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      s_pre[lane * kWordsPerLane + k] = run;
      run += c[k];
    }
    const int members = __shfl_sync(kFull, incl, 31);
    if (lane == 0)
      onepass::store_status(
          status + tile * onepass::kStatusStride,
          onepass::status_word(
              epoch, tile == 0 ? onepass::kInclusive : onepass::kAggregate,
              members));
    int prefix = 0;
    if (tile > 0) {
      prefix = onepass::lookback(status, tile, epoch);
      if (lane == 0)
        onepass::store_status(
            status + tile * onepass::kStatusStride,
            onepass::status_word(epoch, onepass::kInclusive,
                                 prefix + members));
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_members = members;
    }
  }
  __syncthreads();

  const int prefix = s_prefix, total = prefix + s_members;
  const bool last = tile == nblk - 1;
  if (total == prefix && !last) return;  // owns no rank
  if (last && tid == 0) *count = total;
  for (int j = tid; j < batch; j += kThreads) {
    const int r = j == tid ? r_first : rank[j];
    if (r >= prefix && r < total) {
      idx[j] = static_cast<int32_t>(
          tile0 + resolve<kWords>(s_words, s_pre, r - prefix));
    } else if (last && (r < 0 || r >= total)) {
      idx[j] = 0;
    }
  }
}

}  // namespace

// scratch: int32[32 * (nblk + 1)], nblk = ceil(n / 1024), zeroed when
// made: the ticket, then from byte 128 nblk 64-bit status words, one a
// 128-byte line.  `epoch`
// (1 .. 2^30 - 1) differs from the epoch of every earlier call on this
// scratch, and `base` is the ticket's value before this call (the sum of
// the earlier calls' nblk, mod 2^32): the wrapper counts both.  pq must
// be 16-byte and valid 4-byte aligned (common.cuh).  One launch on
// `stream`; returns its error, or 0.
extern "C" int rank_select_launch(const void* pq, const void* valid,
                                  long long n, const void* lo, const void* hi,
                                  int m, const void* rank, int batch,
                                  void* idx, void* count, void* scratch,
                                  unsigned epoch, unsigned base,
                                  void* stream) {
  if (m < 1 || m > kMaxRanges || n < 1 || batch < 0 || n > 0x7fffffffLL ||
      epoch < 1 || epoch >= (1u << 30))
    return cudaErrorInvalidValue;
  const int nblk = static_cast<int>((n + kRows - 1) / kRows);
  unsigned* ticket = static_cast<unsigned*>(scratch);
  rank_select_kernel<<<nblk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pq), static_cast<const uint8_t*>(valid), n,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi), m,
      static_cast<const int32_t*>(rank), batch, static_cast<int32_t*>(idx),
      static_cast<int32_t*>(count), ticket,
      reinterpret_cast<unsigned long long*>(ticket + 32), nblk, epoch, base);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rank_select_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
