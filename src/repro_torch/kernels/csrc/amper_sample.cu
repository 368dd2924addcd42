// The whole AMPER-fr draw for Hopper in one cooperative launch: match,
// CSP count, threefry pick, rank select.
//
// Replaces the Pallas kernel repro/kernels/amper_sample.py:103
// (amper_sample_kernel, called through amper_sample at :217).  Same
// function as the port's kernels/amper_sample.py::amper_sample_ref:
//
//   sel[r]  = valid[r] && OR_i (lo_i <= pq[r] <= hi_i)
//   total   = #members,  s_shift = #members below `shift`,  live = #valid
//   count   = min(total, csp_capacity)
//   (pk, fk) = split(key)          (threefry, jax's partitionable layout)
//   u_j     = bits(pk)[j] % max(count, 1)
//   rank_j  = (u_j + s_shift) % max(total, 1)
//   idx[j]  = total > 0 ? flat index of the rank_j-th member (index order)
//                       : bits(fk)[j] % max(live, 1)
//   stats   = [total, s_shift, live, count]
//
// The rank identity: the reference rolls the selection by -shift and
// compacts it, so its u-th CSP entry is the member of ordinary rank
// (u + s_shift) % total.  Selecting that member straight from the match
// gives the same index without building the compacted CSP.  `shift` and
// the key come as launch arguments or from device memory (a CUDA graph
// replays with what its inputs hold then); "members below shift" counts
// the members at index < shift, as the Pallas kernel's gidx < shift does,
// also for a shift outside [0, n).
//
// Bound: bytes.  Every row is read once (4 B of pq + 1 B of valid): about
// 1.5 us at n = 1e6 on an H100 SXM (3.35 TB/s).  The threefry rounds
// (~100 integer operations a draw) are small beside it.  What remains is
// the chain of dependent memory round trips: rows, look-back, the last
// tile's count reaching every block.
//
// Design: the TPU kernel ran a sequential grid (phase 0 fills scalar
// counts, phase 1 reads them) and gathered with one-hot f32 matmuls.  The
// ranks here depend on the table's total and s_shift, so no tile can
// resolve a draw until the last tile is counted: every block waits for
// the last one, which a ticket scheme (blocks wait only on blocks that
// started before them) cannot allow.  So it is one cooperative launch of
// at most one wave, every block resident at once, built from onepass.cuh:
//   * block b takes the 1024-row tiles b, b + G, ... (G blocks: at the
//     kernel's 72 registers 7 fit an SM, so on an H100 a 250k shard runs
//     245 blocks of one tile and n = 1e6 489 of two; capped at 64 to fit
//     8, it spilled and ran no faster), reads each tile's rows once (int4 +
//     uchar4 loads, the next tile's in flight), tests them on the FP32
//     pipe, keeps the tile's membership in shared memory as 32 words
//     with their in-tile prefixes, counts its live rows, and publishes
//     the tile's member count (aggregate) without waiting;
//   * then one warp finds each of its tiles' exclusive member prefixes in
//     increasing tile order by decoupled look-back and publishes them
//     (inclusive); a tile waits only on lower tiles, whose blocks are all
//     running, so the spin ends.  The tile that holds `shift` adds its
//     members below it to its prefix and publishes that as s_shift;
//   * every block derives the pick key and its draws' bits while its rows
//     are in flight, then reads the total from the last tile's inclusive
//     word and s_shift from the shift word, and resolves the ranks that
//     fall in its own tiles from shared memory alone (a binary search over
//     the word prefixes, then the set bit); the table is not read again,
//     and each rank lies in exactly one tile, so idx needs no zeroing;
//   * each block adds (1 << 40) + its live rows to a done word as it
//     starts its draws (a thread of the last warp waits for the add);
//     the block that completed it knows the live total: it writes the
//     stats, the fallback draws when the CSP is empty, resets the word
//     and moves the scratch's epoch on (onepass.cuh: epochs on the card).
// No f32 gathers remain, so the TPU kernel's frac_bits <= 24 limit is
// kept only so both packages refuse the same configurations.  A block
// keeps its tiles' words in shared memory (264 B a tile), so the largest
// table is the one whose tiles fill the shared memory of a resident grid
// (amper_sample_max_rows; about 1.2e8 rows on an H100); the wrapper
// refuses larger tables.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "common.cuh"
#include "onepass.cuh"
#include "threefry.cuh"

namespace {

using amper::kFull;
using amper::kMaxRanges;
using threefry::key_bits;
using threefry::threefry2x32;

constexpr int kThreads = 128;                 // a block's threads
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 2;                     // 4-row loads a thread
constexpr int kRows = 4 * kThreads * kLoads;  // tile rows: 1024
constexpr int kWords = kRows / 32;            // membership words of a tile
// dynamic shared memory of a tile: its words and their prefixes, then
// (after every tile's) its exclusive member prefix and its members
constexpr int kTileBytes = (2 * kWords + 2) * 4;

struct Params {
  const int32_t* pq;
  const uint8_t* valid;
  long long n;
  const int32_t* lo;
  const int32_t* hi;
  int m;
  long long shift;             // when shift_ptr is null
  const int32_t* shift_ptr;    // int32 on the device, or null
  unsigned k0, k1;             // when key_ptr is null
  const long long* key_ptr;    // two int64 words on the device, or null
  int batch, csp_capacity;
  int32_t* idx;
  int32_t* stats;
  unsigned* epoch_word;                // scratch: the last call's epoch
  unsigned long long* done;            // blocks << 40 | live rows so far
  unsigned long long* shift_word;      // s_shift, as a status word
  unsigned long long* status;          // a status word a tile
  int nblk, capacity;                  // tiles; status words of scratch
};

// Spins until *w is an inclusive word of this epoch; returns its count.
__device__ __forceinline__ int wait_inclusive(const unsigned long long* w,
                                              unsigned epoch) {
  unsigned long long x;
  while (onepass::status_flag(x = onepass::load_status(w), epoch) !=
         onepass::kInclusive)
    __nanosleep(32);
  return static_cast<int>(static_cast<unsigned>(x));
}

__global__ void __launch_bounds__(kThreads)
    amper_sample_kernel(const Params P) {
  extern __shared__ int s_dyn[];
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  __shared__ float s_l[kMaxRanges], s_h[kMaxRanges];
  __shared__ onepass::Window s_win;
  __shared__ int s_live[kWarps];
  __shared__ unsigned s_epoch;
  __shared__ int s_total, s_below, s_live_all;
  __shared__ bool s_finisher;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const int K = (P.nblk - 1 - b) / G + 1;  // this block's tiles (grid <= nblk)
  unsigned* s_words = reinterpret_cast<unsigned*>(s_dyn);  // [K][kWords]
  int* s_pre = s_dyn + K * kWords;                         // [K][kWords]
  int* s_tpre = s_pre + K * kWords;                        // [K]
  int* s_tmem = s_tpre + K;                                // [K]
  const long long n = P.n;

  if (tid == 0) s_epoch = *P.epoch_word + 1;
  onepass::LaneRanges ranges;
  if (warp == 0) ranges = onepass::load_lane_ranges(P.lo, P.hi, P.m);
  const long long raw_shift = P.shift_ptr ? *P.shift_ptr : P.shift;
  const long long shift = raw_shift < 0 ? 0 : raw_shift > n ? n : raw_shift;
  uint32_t k0 = P.k0, k1 = P.k1;
  if (P.key_ptr) {
    k0 = static_cast<uint32_t>(P.key_ptr[0]);
    k1 = static_cast<uint32_t>(P.key_ptr[1]);
  }
  onepass::Rows<kLoads> cur = onepass::load_rows<kThreads, kLoads>(
      P.pq, P.valid, n, static_cast<long long>(b) * kRows);
  if (warp == 0) {  // while the rows are in flight
    const onepass::Window w =
        onepass::prepare_ranges(ranges, P.m, s_lo, s_hi, s_l, s_h);
    if (lane == 0) s_win = w;
  }
  // the pick key and this thread's first draw, also while they fly
  uint32_t pk0 = 0, pk1 = 0;
  threefry2x32(k0, k1, pk0, pk1);
  const uint32_t bits_first = tid < P.batch ? key_bits(pk0, pk1, tid) : 0;
  __syncthreads();

  // Every tile of the block: rows, tests, words, aggregate count.
  int live = 0;
  for (int k = 0; k < K; ++k) {
    const long long t = b + static_cast<long long>(k) * G;
    onepass::Rows<kLoads> nxt;
    if (k + 1 < K)
      nxt = onepass::load_rows<kThreads, kLoads>(P.pq, P.valid, n,
                                                 (t + G) * kRows);
    int32_t p[4 * kLoads];
    bool v[4 * kLoads], mem[4 * kLoads];
    onepass::unpack(cur, p, v);
    onepass::test_rows<4 * kLoads>(p, v, s_win, P.m, s_lo, s_hi, s_l, s_h,
                                   mem);
#pragma unroll
    for (int r = 0; r < 4 * kLoads; ++r) live += v[r];
    onepass::store_words<kThreads, kLoads>(mem, s_words + k * kWords);
    __syncthreads();
    if (warp == 0) {
      const int members = onepass::word_prefixes<kWords>(
          s_words + k * kWords, s_pre + k * kWords);
      if (lane == 0) {
        s_tmem[k] = members;
        onepass::store_status(
            P.status + t * onepass::kStatusStride,
            onepass::status_word(
                s_epoch, t == 0 ? onepass::kInclusive : onepass::kAggregate,
                members));
      }
    }
    cur = nxt;
  }
  live = static_cast<int>(
      __reduce_add_sync(kFull, static_cast<unsigned>(live)));
  if (lane == 0) s_live[warp] = live;
  __syncthreads();

  // One warp: the tiles' prefixes, s_shift and the total.
  if (warp == 0) {
    const unsigned epoch = s_epoch;
    const long long ts = shift / kRows;  // the tile holding `shift`
    int below = shift == 0 ? 0 : -1, total = -1;
    for (int k = 0; k < K; ++k) {
      const int t = b + k * G;
      int prefix = 0;
      if (t > 0) {
        prefix = onepass::lookback(P.status, t, epoch);
        if (lane == 0)
          onepass::store_status(
              P.status + t * onepass::kStatusStride,
              onepass::status_word(epoch, onepass::kInclusive,
                                   prefix + s_tmem[k]));
      }
      if (lane == 0) s_tpre[k] = prefix;
      if (t == P.nblk - 1) total = prefix + s_tmem[k];
      if (shift > 0 && shift < n && t == ts) {
        const int off = static_cast<int>(shift - ts * kRows);
        const unsigned w = s_words[k * kWords + off / 32];
        below = prefix + s_pre[k * kWords + off / 32] +
                __popc(w & ((1u << (off % 32)) - 1u));
        if (lane == 0)
          onepass::store_status(
              P.shift_word,
              onepass::status_word(epoch, onepass::kInclusive, below));
      }
    }
    if (total < 0)
      total = wait_inclusive(P.status + (P.nblk - 1) * onepass::kStatusStride,
                             epoch);
    if (below < 0)
      below = shift >= n ? total : wait_inclusive(P.shift_word, epoch);
    if (lane == 0) {
      s_total = total;
      s_below = below;
    }
  }
  __syncthreads();
  // This block reads no status word again: it arrives with its live rows.
  // A thread of the last warp waits for the add, which draws only past
  // batch 96; the others go on to their draws.
  if (tid == kThreads - 1) {
    const unsigned live_b = s_live[0] + s_live[1] + s_live[2] + s_live[3];
    const unsigned long long old =
        onepass::arrive(P.done, (1ull << 40) | live_b, s_epoch);
    s_finisher = (old >> 40) == static_cast<unsigned long long>(G - 1);
    s_live_all = static_cast<int>((old + live_b) & ((1ull << 40) - 1));
  }

  const int total = s_total, below = s_below;
  const int count = min(total, P.csp_capacity);
  const uint32_t pick_mod = static_cast<uint32_t>(max(count, 1));
  for (int j = tid; total > 0 && j < P.batch; j += kThreads) {
    const uint32_t u =
        (j == tid ? bits_first : key_bits(pk0, pk1, j)) % pick_mod;
    const int r = static_cast<int>(
        (static_cast<unsigned long long>(u) + static_cast<uint32_t>(below)) %
        static_cast<uint32_t>(total));
    if (r < s_tpre[0]) continue;
    int lo = 0, hi = K - 1;  // the last own tile whose prefix is <= r
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_tpre[mid] <= r) lo = mid; else hi = mid - 1;
    }
    const int lr = r - s_tpre[lo];
    if (lr >= s_tmem[lo]) continue;  // another block's tile holds it
    const long long t = b + static_cast<long long>(lo) * G;
    P.idx[j] = static_cast<int32_t>(
        t * kRows + onepass::resolve<kWords>(s_words + lo * kWords,
                                             s_pre + lo * kWords, lr));
  }
  __syncthreads();
  if (!s_finisher) return;
  // every block has arrived: the stats, the fallbacks, the next epoch
  const int n_live = s_live_all;
  if (tid == 0) {
    P.stats[0] = total;
    P.stats[1] = below;
    P.stats[2] = n_live;
    P.stats[3] = count;
    *P.done = 0;
    if (s_epoch == onepass::kMaxEpoch) *P.shift_word = 0;
    onepass::finish_call(P.epoch_word, s_epoch, P.status, P.capacity);
  }
  if (total == 0) {  // empty CSP: uniform over the live rows
    uint32_t fk0 = 0, fk1 = 1;
    threefry2x32(k0, k1, fk0, fk1);
    const uint32_t live_mod = static_cast<uint32_t>(max(n_live, 1));
    for (int j = tid; j < P.batch; j += kThreads)
      P.idx[j] = static_cast<int32_t>(key_bits(fk0, fk1, j) % live_mod);
  }
}

// Host side: the grid.  A call needs every block resident at once, and a
// block keeps its tiles in shared memory, so the plan is the fewest tiles
// a block whose resident grid covers the table.
std::mutex g_lock;
int g_dyn_limit = -1;             // dynamic shared memory a block may take
std::vector<int> g_blocks_per_sm;  // by tiles a block; 0 = not asked yet

// Called with g_lock held: the largest tiles a block (0 on error).
int max_tiles_per_block() {
  if (g_dyn_limit < 0) {
    cudaFuncAttributes attr;
    int dev = 0, optin = 0;
    if (cudaFuncGetAttributes(&attr, amper_sample_kernel) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 0;
    const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(amper_sample_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit) != cudaSuccess)
      return 0;
    g_dyn_limit = limit;
    g_blocks_per_sm.assign(limit / kTileBytes + 1, 0);
  }
  return g_dyn_limit / kTileBytes;
}

// Called with g_lock held: resident blocks an SM at k tiles a block.
int blocks_per_sm(int k) {
  int& b = g_blocks_per_sm[k];
  if (b == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &b, amper_sample_kernel, kThreads,
                    static_cast<size_t>(k) * kTileBytes) != cudaSuccess)
    b = 0;
  return b;
}

}  // namespace

// The largest table (rows) a call takes on a card of `sms` SMs, or -1 on
// a CUDA error.
extern "C" long long amper_sample_max_rows(int sms) {
  std::lock_guard<std::mutex> guard(g_lock);
  const int kmax = max_tiles_per_block();
  if (kmax < 1) return -1;
  long long tiles = 0;
  for (int k = 1; k <= kmax; ++k) {
    const long long t = static_cast<long long>(blocks_per_sm(k)) * sms * k;
    if (t > tiles) tiles = t;
  }
  const long long rows = tiles * kRows;
  return rows < 0x7fffffffLL ? rows : 0x7fffffffLL;
}

// scratch: int32[64 + 32 * capacity] with capacity >= ceil(n / 1024),
// zeroed when made and never filled again: the epoch (int32 0) and the
// done word (bytes 8-15) in the first 128-byte line, the s_shift word in
// the second, then `capacity` 64-bit status words, one a 128-byte line.
// Calls on one scratch must not run at once (the wrapper keeps one a
// stream).  shift_ptr (int32) and key_ptr (two int64) point at the
// device, or are null to take `shift` and (k0, k1).  pq must be 16-byte
// and valid 4-byte aligned (common.cuh).  One cooperative launch on
// `stream`; returns its error, or 0.
extern "C" int amper_sample_launch(
    const void* pq, const void* valid, long long n, const void* lo,
    const void* hi, int m, long long shift, const void* shift_ptr,
    unsigned k0, unsigned k1, const void* key_ptr, int batch,
    int csp_capacity, void* idx, void* stats, void* scratch, int capacity,
    int sms, void* stream) {
  if (m < 1 || m > kMaxRanges || n < 1 || batch < 1 || csp_capacity < 1 ||
      n > 0x7fffffffLL || sms < 1)
    return cudaErrorInvalidValue;
  const int nblk = static_cast<int>((n + kRows - 1) / kRows);
  if (capacity < nblk) return cudaErrorInvalidValue;
  int per_block = 0, grid = 0;
  {
    std::lock_guard<std::mutex> guard(g_lock);
    const int kmax = max_tiles_per_block();
    for (int k = 1; k <= kmax && !per_block; ++k)
      if (static_cast<long long>(blocks_per_sm(k)) * sms * k >= nblk) {
        per_block = k;
        grid = (nblk + k - 1) / k;
      }
  }
  if (!per_block) return cudaErrorInvalidValue;  // past max_rows
  auto* words = static_cast<unsigned*>(scratch);
  Params P;
  P.pq = static_cast<const int32_t*>(pq);
  P.valid = static_cast<const uint8_t*>(valid);
  P.n = n;
  P.lo = static_cast<const int32_t*>(lo);
  P.hi = static_cast<const int32_t*>(hi);
  P.m = m;
  P.shift = shift;
  P.shift_ptr = static_cast<const int32_t*>(shift_ptr);
  P.k0 = k0;
  P.k1 = k1;
  P.key_ptr = static_cast<const long long*>(key_ptr);
  P.batch = batch;
  P.csp_capacity = csp_capacity;
  P.idx = static_cast<int32_t*>(idx);
  P.stats = static_cast<int32_t*>(stats);
  P.epoch_word = words;
  P.done = reinterpret_cast<unsigned long long*>(words + 2);
  P.shift_word = reinterpret_cast<unsigned long long*>(words + 32);
  P.status = reinterpret_cast<unsigned long long*>(words + 64);
  P.nblk = nblk;
  P.capacity = capacity;
  void* args[] = {&P};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(amper_sample_kernel), dim3(grid),
      dim3(kThreads), args, static_cast<size_t>(per_block) * kTileBytes,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* amper_sample_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
