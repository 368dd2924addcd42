// Row loads, the m-range test and the three-launch rank-select scheme of
// the AMPER-fr kernels.
//
// The wrappers (kernels/ops.py) pass only tables whose pq starts on a
// 16-byte and valid on a 4-byte boundary, as the caching allocator gives
// them, so every whole group of 4 rows is one int4 and one uchar4 load;
// only the ragged tail past the last whole group reads row by row.
// amper_sample.cu, tcam_match.cu and the one-launch kernels' tiles
// (onepass.cuh) load rows through here.
//
// Rank select in three launches (amper_sample.cu; rank_select.cu and
// multi_query_match.cu are one launch each, built from onepass.cuh):
// finding the flat index of the r-th member of the match, in index
// order, without a sequential grid and without atomics, on one stream:
//   1. count:  one block per 1024-row tile writes the tile's (members,
//              members below `shift`, live rows) to tiles[nblk][3]
//              (count_tile);
//   2. scan:   one block turns the tile member counts into their
//              exclusive prefix and the table totals (scan_tiles);
//   3. select: one warp per rank binary-searches the prefix for the tile
//              that holds the rank, re-matches that tile 128 rows at a
//              time (4 rows a lane) and finds the member with a warp
//              prefix sum (select_member).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace amper {

constexpr int kMaxRanges = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;       // threads of a count / select block
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;  // rows per tile
constexpr int kScanThreads = 1024;  // threads of the one scan block

// Loads pq rows row0 .. row0+3 (row0 a multiple of 4); rows at or past n
// read as -1.
__device__ __forceinline__ void load4(const int32_t* __restrict__ pq,
                                      long long n, long long row0,
                                      int32_t p[4]) {
  if (row0 + 4 <= n) {
    const int4 p4 = *reinterpret_cast<const int4*>(pq + row0);
    p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = row0 + k < n ? pq[row0 + k] : -1;
  }
}

// Loads rows row0 .. row0+3 of pq and valid; rows at or past n read as
// invalid.
__device__ __forceinline__ void load4(const int32_t* __restrict__ pq,
                                      const uint8_t* __restrict__ valid,
                                      long long n, long long row0,
                                      int32_t p[4], bool v[4]) {
  load4(pq, n, row0, p);
  if (row0 + 4 <= n) {
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(valid + row0);
    v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = row0 + k < n && valid[row0 + k] != 0;
  }
}

// Stores 4 flags at rows row0 .. row0+3 (out 4-byte aligned); rows at or
// past n are not written.
__device__ __forceinline__ void store4(uint8_t* __restrict__ out, long long n,
                                       long long row0, const bool s[4]) {
  if (row0 + 4 <= n) {
    *reinterpret_cast<uchar4*>(out + row0) = make_uchar4(s[0], s[1], s[2], s[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (row0 + k < n) out[row0 + k] = s[k];
  }
}

// valid && OR_i (lo_i <= p <= hi_i)
__device__ __forceinline__ bool member(int32_t p, bool v, const int32_t* lo,
                                       const int32_t* hi, int m) {
  bool s = false;
  for (int i = 0; i < m; ++i) s |= (p >= lo[i]) & (p <= hi[i]);
  return s && v;
}

// Copies the m ranges into shared memory; every thread of the block must
// call it.
__device__ __forceinline__ void load_ranges(const int32_t* __restrict__ lo,
                                            const int32_t* __restrict__ hi,
                                            int m, int32_t* s_lo,
                                            int32_t* s_hi) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
}

// Sum over the block; the result is valid in every thread.
__device__ __forceinline__ int block_sum(int x, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(kFull, static_cast<unsigned>(x));
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += scratch[w];
  return s;
}

// Launch 1, the body of a kernel of kThreads threads and one block per
// tile: tiles[3 t + 0..2] = members, members below `shift`, live rows of
// tile t = blockIdx.x.
__device__ __forceinline__ void count_tile(const int32_t* __restrict__ pq,
                                           const uint8_t* __restrict__ valid,
                                           long long n,
                                           const int32_t* __restrict__ lo,
                                           const int32_t* __restrict__ hi,
                                           int m, long long shift,
                                           int32_t* __restrict__ tiles) {
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  __shared__ int scratch[32];
  load_ranges(lo, hi, m, s_lo, s_hi);
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kTileRows + threadIdx.x * 4;
  int32_t p[4];
  bool v[4];
  load4(pq, valid, n, row0, p, v);
  int mem = 0, below = 0, live = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool s = member(p[k], v[k], s_lo, s_hi, m);
    mem += s;
    below += s && (row0 + k < shift);
    live += v[k];
  }
  mem = block_sum(mem, scratch);
  below = block_sum(below, scratch);
  live = block_sum(live, scratch);
  if (threadIdx.x == 0) {
    tiles[3 * blockIdx.x + 0] = mem;
    tiles[3 * blockIdx.x + 1] = below;
    tiles[3 * blockIdx.x + 2] = live;
  }
}

struct TileTotals {
  int members, below, live;
};

// Launch 2, called by every thread of one block: prefix[t] = members of
// tiles 0 .. t-1; returns the table's totals in every thread.  Threads
// own runs of consecutive tiles, so one scan of their sums orders them.
__device__ __forceinline__ TileTotals scan_tiles(
    const int32_t* __restrict__ tiles, int nblk,
    int32_t* __restrict__ prefix) {
  __shared__ int scratch[32];
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int t0 = min(tid * per, nblk), t1 = min(t0 + per, nblk);
  int mem = 0, below = 0, live = 0;
  for (int t = t0; t < t1; ++t) {
    mem += tiles[3 * t];
    below += tiles[3 * t + 1];
    live += tiles[3 * t + 2];
  }
  int incl = mem;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  int run = before + incl - mem;
  for (int t = t0; t < t1; ++t) {
    prefix[t] = run;
    run += tiles[3 * t];
  }
  TileTotals out;
  out.members = block_sum(mem, scratch);
  out.below = block_sum(below, scratch);
  out.live = block_sum(live, scratch);
  return out;
}

// Launch 3, called by all 32 lanes of a warp: the flat index of the
// member of rank `rank` (0 <= rank < members), given the tile prefix of
// scan_tiles and the ranges in shared memory.
__device__ __forceinline__ int32_t select_member(
    const int32_t* __restrict__ pq, const uint8_t* __restrict__ valid,
    long long n, const int32_t* s_lo, const int32_t* s_hi, int m,
    const int32_t* __restrict__ prefix, int nblk, int rank) {
  const int lane = threadIdx.x & 31;
  // Last tile whose member prefix is <= rank; it holds the member, since
  // prefix[0] == 0 <= rank < members.
  int l = 0, r = nblk;
  while (r - l > 1) {
    const int mid = (l + r) >> 1;
    if (prefix[mid] <= rank) l = mid; else r = mid;
  }
  int lr = rank - prefix[l];
  const long long tile0 = static_cast<long long>(l) * kTileRows;
  for (int base = 0; base < kTileRows; base += 128) {
    const long long row0 = tile0 + base + 4 * lane;
    int32_t p[4];
    bool v[4], s[4];
    load4(pq, valid, n, row0, p, v);
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = member(p[k], v[k], s_lo, s_hi, m);
      c += s[k];
    }
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int warp_total = __shfl_sync(kFull, incl, 31);
    if (lr < warp_total) {
      const int excl = incl - c;
      int hit = -1;
      if (excl <= lr && lr < incl) {
        int want = lr - excl;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (s[k]) {
            if (want == 0 && hit < 0) hit = k;
            --want;
          }
        }
      }
      const unsigned owner = __ballot_sync(kFull, hit >= 0);
      const int src = __ffs(owner) - 1;
      const int k = __shfl_sync(kFull, hit, src);
      return static_cast<int32_t>(tile0 + base + 4 * src + k);
    }
    lr -= warp_total;
  }
  return -1;  // unreachable for 0 <= rank < members
}

}  // namespace amper
