// The whole AMPER-fr draw for Hopper: match, CSP count, threefry pick,
// rank select.
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
// gives the same index without building the compacted CSP.
//
// Bound: bytes.  Launch 1 reads every row once (4 B of pq + 1 B of
// valid: about 1.5 us at n = 1e6 on an H100 SXM, 3.35 TB/s); launch 3
// re-reads at most one 1024-row tile (5 KiB) per draw.  The threefry
// rounds (~100 integer operations per draw) and the scan over the tile
// counts are small beside it, so at n = 1e6 the three launches' fixed
// cost dominates.
//
// Design: the TPU kernel ran a sequential grid (phase 0 fills scalar
// counts, phase 1 reads them) and gathered with one-hot f32 matmuls.
// CUDA blocks run in no order, so the draw is three launches on one
// stream, with no atomics and a deterministic result:
//   1. count:  one block per 1024-row tile writes the tile's
//              (members, members below shift, live) to tiles[nblk][3];
//   2. draw:   one block scans the tile counts (exclusive prefix of
//              members), derives the pick and fallback keys, and draws
//              the batch's ranks and fallbacks;
//   3. select: one warp per draw binary-searches the tile prefix for the
//              tile holding its rank, re-matches that tile 128 rows at a
//              time (4 rows a lane) and finds the member with a warp
//              prefix sum.
// No f32 gathers remain, so the TPU kernel's frac_bits <= 24 limit is
// kept only so both packages refuse the same configurations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using amper::kFull;
using amper::kMaxRanges;
using amper::load4;
using amper::member;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;  // rows per tile
constexpr int kDrawThreads = 1024;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32, 20 rounds: jax._src.prng.threefry_2x32 bit for bit.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
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

__global__ void count_kernel(const int32_t* __restrict__ pq,
                             const uint8_t* __restrict__ valid, long long n,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int m,
                             long long shift, int32_t* __restrict__ tiles) {
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  __shared__ int scratch[32];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
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

__global__ void draw_kernel(const int32_t* __restrict__ tiles, int nblk,
                            uint32_t k0, uint32_t k1, int batch,
                            int csp_capacity, int32_t* __restrict__ prefix,
                            int32_t* __restrict__ draws,
                            int32_t* __restrict__ stats) {
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
  // Exclusive scan of the threads' member sums (threads own tiles in
  // order), then each thread writes the prefix of its own tiles.
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
  const int total = block_sum(mem, scratch);
  const int s_shift = block_sum(below, scratch);
  const int n_live = block_sum(live, scratch);
  const int count = min(total, csp_capacity);

  // split(key): subkey j is threefry(key, (0, j)).
  uint32_t pk0 = 0, pk1 = 0, fk0 = 0, fk1 = 1;
  threefry2x32(k0, k1, pk0, pk1);
  threefry2x32(k0, k1, fk0, fk1);
  const uint32_t pick_mod = static_cast<uint32_t>(max(count, 1));
  const uint32_t total_mod = static_cast<uint32_t>(max(total, 1));
  const uint32_t live_mod = static_cast<uint32_t>(max(n_live, 1));
  for (int j = tid; j < batch; j += blockDim.x) {
    uint32_t a0 = 0, a1 = static_cast<uint32_t>(j);
    threefry2x32(pk0, pk1, a0, a1);
    const uint32_t u = (a0 ^ a1) % pick_mod;
    const uint32_t rank = static_cast<uint32_t>(
        (static_cast<unsigned long long>(u) + static_cast<uint32_t>(s_shift)) %
        total_mod);
    uint32_t b0 = 0, b1 = static_cast<uint32_t>(j);
    threefry2x32(fk0, fk1, b0, b1);
    draws[j] = static_cast<int32_t>(rank);
    draws[batch + j] = static_cast<int32_t>((b0 ^ b1) % live_mod);
  }
  if (tid == 0) {
    stats[0] = total;
    stats[1] = s_shift;
    stats[2] = n_live;
    stats[3] = count;
  }
}

__global__ void select_kernel(const int32_t* __restrict__ pq,
                              const uint8_t* __restrict__ valid, long long n,
                              const int32_t* __restrict__ lo,
                              const int32_t* __restrict__ hi, int m,
                              const int32_t* __restrict__ prefix, int nblk,
                              const int32_t* __restrict__ draws,
                              const int32_t* __restrict__ stats, int batch,
                              int32_t* __restrict__ idx) {
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= batch) return;  // whole warps leave together
  if (stats[0] == 0) {  // empty CSP: uniform over the live rows
    if (lane == 0) idx[j] = draws[batch + j];
    return;
  }
  const int rank = draws[j];
  // Last tile whose member prefix is <= rank; it holds the member, since
  // prefix[0] == 0 <= rank < total.
  int l = 0, r = nblk;
  while (r - l > 1) {
    const int mid = (l + r) >> 1;
    if (prefix[mid] <= rank) l = mid; else r = mid;
  }
  int lr = rank - prefix[l];
  const long long tile0 = static_cast<long long>(l) * kTileRows;
  int32_t found = -1;
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
      found = static_cast<int32_t>(tile0 + base + 4 * src + k);
      break;
    }
    lr -= warp_total;
  }
  if (lane == 0) idx[j] = found;
}

}  // namespace

// scratch: int32[4 * nblk + 2 * batch] with nblk = ceil(n / 1024).  pq
// must be 16-byte and valid 4-byte aligned (common.cuh).  Three launches
// on `stream`; returns the first launch error, or 0.
extern "C" int amper_sample_launch(
    const void* pq, const void* valid, long long n, const void* lo,
    const void* hi, int m, long long shift, unsigned k0, unsigned k1,
    int batch, int csp_capacity, void* idx, void* stats, void* scratch,
    void* stream) {
  if (m < 1 || m > kMaxRanges || n < 1 || batch < 1 ||
      n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = static_cast<int>((n + kTileRows - 1) / kTileRows);
  int32_t* tiles = static_cast<int32_t*>(scratch);
  int32_t* prefix = tiles + 3 * nblk;
  int32_t* draws = prefix + nblk;
  const int32_t* p = static_cast<const int32_t*>(pq);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* h = static_cast<const int32_t*>(hi);

  count_kernel<<<nblk, kThreads, 0, s>>>(p, v, n, l, h, m, shift, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  draw_kernel<<<1, kDrawThreads, 0, s>>>(
      tiles, nblk, k0, k1, batch, csp_capacity, prefix, draws,
      static_cast<int32_t*>(stats));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kThreads / 32;
  select_kernel<<<(batch + warps - 1) / warps, kThreads, 0, s>>>(
      p, v, n, l, h, m, prefix, nblk, draws,
      static_cast<const int32_t*>(stats), batch, static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amper_sample_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
