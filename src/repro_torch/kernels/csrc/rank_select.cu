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
// blocks already running.  Flag reuse: the ticket, the done counter, the
// epoch and the status words live in the wrapper's scratch, zeroed once
// when made; every status word carries the call's epoch, so words of an
// earlier call read as unpublished, and the block that finishes a call
// last puts the ticket and the counter back to 0 and moves the epoch on
// (onepass.cuh: epochs on the card).  No block waits for the others at
// the end and the host counts nothing, so a call can be captured in a
// CUDA graph.  The result is exact integer arithmetic, independent of
// block order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "onepass.cuh"

namespace {

using amper::kMaxRanges;

constexpr int kThreads = 128;             // a block's threads
constexpr int kLoads = 2;                 // 4-row loads a thread
constexpr int kRows = 4 * kThreads * kLoads;  // tile rows: 1024

// A block of kThreads threads over a tile of kRows rows.
__global__ void __launch_bounds__(kThreads) rank_select_kernel(
    const int32_t* __restrict__ pq, const uint8_t* __restrict__ valid,
    long long n, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, int m, const int32_t* __restrict__ rank,
    int batch, int32_t* __restrict__ idx, int32_t* __restrict__ count,
    unsigned* __restrict__ words, unsigned long long* __restrict__ status,
    int nblk, int capacity) {
  constexpr int kWords = kRows / 32;  // membership words of a tile
  unsigned* ticket = words;
  unsigned* done = words + 1;
  unsigned* epoch_word = words + 2;
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  __shared__ float s_l[kMaxRanges], s_h[kMaxRanges];
  __shared__ unsigned s_words[kWords];
  __shared__ int s_pre[kWords];
  __shared__ int s_tile, s_prefix, s_members;
  __shared__ unsigned s_epoch;
  __shared__ onepass::Window s_win;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
    s_tile = static_cast<int>(atomicAdd(ticket, 1u));
    s_epoch = *epoch_word + 1;
  }
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
  onepass::test_rows<4 * kLoads>(p, v, s_win, m, s_lo, s_hi, s_l, s_h, mem);
  onepass::store_words<kThreads, kLoads>(mem, s_words);
  __syncthreads();

  if (tid < 32) {
    const unsigned epoch = s_epoch;
    const int members = onepass::word_prefixes<kWords>(s_words, s_pre);
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
  // This block reads no status word again: it arrives, and reads the old
  // count after its ranks.
  const unsigned arrived = tid == 0 ? onepass::arrive(done, 1u, s_epoch) : 0;
  __syncthreads();

  const int prefix = s_prefix, total = prefix + s_members;
  const bool last = tile == nblk - 1;
  if (last && tid == 0) *count = total;
  if (total > prefix || last) {  // else it owns no rank
    for (int j = tid; j < batch; j += kThreads) {
      const int r = j == tid ? r_first : rank[j];
      if (r >= prefix && r < total) {
        idx[j] = static_cast<int32_t>(
            tile0 + onepass::resolve<kWords>(s_words, s_pre, r - prefix));
      } else if (last && (r < 0 || r >= total)) {
        idx[j] = 0;
      }
    }
  }
  if (tid == 0 && arrived == static_cast<unsigned>(nblk - 1)) {
    // the last to arrive puts the ticket and the counter back and moves
    // the epoch on
    *ticket = 0;
    *done = 0;
    onepass::finish_call(epoch_word, s_epoch, status, capacity);
  }
}

}  // namespace

// scratch: int32[32 * (capacity + 1)] with capacity >= nblk =
// ceil(n / 1024), zeroed when made and never filled again: the ticket,
// the done counter and the epoch in its first 128-byte line, then
// `capacity` 64-bit status words, one a 128-byte line.  Calls on one
// scratch must not run at once (the wrapper keeps one a stream).  pq must
// be 16-byte and valid 4-byte aligned (common.cuh).  One launch on
// `stream`; returns its error, or 0.
extern "C" int rank_select_launch(const void* pq, const void* valid,
                                  long long n, const void* lo, const void* hi,
                                  int m, const void* rank, int batch,
                                  void* idx, void* count, void* scratch,
                                  int capacity, void* stream) {
  if (m < 1 || m > kMaxRanges || n < 1 || batch < 0 || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int nblk = static_cast<int>((n + kRows - 1) / kRows);
  if (capacity < nblk) return cudaErrorInvalidValue;
  unsigned* words = static_cast<unsigned*>(scratch);
  rank_select_kernel<<<nblk, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pq), static_cast<const uint8_t*>(valid), n,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi), m,
      static_cast<const int32_t*>(rank), batch, static_cast<int32_t*>(idx),
      static_cast<int32_t*>(count), words,
      reinterpret_cast<unsigned long long*>(words + 32), nblk, capacity);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rank_select_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
