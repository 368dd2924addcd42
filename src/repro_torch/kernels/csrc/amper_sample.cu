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
// CUDA blocks run in no order, so the draw is the three launches of the
// rank-select scheme in common.cuh, on one stream, with no atomics and a
// deterministic result:
//   1. count:  per-tile (members, members below shift, live);
//   2. draw:   one block scans the tile counts, derives the pick and
//              fallback keys, and draws the batch's ranks and fallbacks;
//   3. select: one warp per draw finds the member of its rank.
// No f32 gathers remain, so the TPU kernel's frac_bits <= 24 limit is
// kept only so both packages refuse the same configurations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using amper::kMaxRanges;
using amper::kScanThreads;
using amper::kThreads;
using amper::kTileRows;

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

__global__ void count_kernel(const int32_t* __restrict__ pq,
                             const uint8_t* __restrict__ valid, long long n,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int m,
                             long long shift, int32_t* __restrict__ tiles) {
  amper::count_tile(pq, valid, n, lo, hi, m, shift, tiles);
}

__global__ void draw_kernel(const int32_t* __restrict__ tiles, int nblk,
                            uint32_t k0, uint32_t k1, int batch,
                            int csp_capacity, int32_t* __restrict__ prefix,
                            int32_t* __restrict__ draws,
                            int32_t* __restrict__ stats) {
  const amper::TileTotals tot = amper::scan_tiles(tiles, nblk, prefix);
  const int total = tot.members, s_shift = tot.below, n_live = tot.live;
  const int count = min(total, csp_capacity);

  // split(key): subkey j is threefry(key, (0, j)).
  uint32_t pk0 = 0, pk1 = 0, fk0 = 0, fk1 = 1;
  threefry2x32(k0, k1, pk0, pk1);
  threefry2x32(k0, k1, fk0, fk1);
  const uint32_t pick_mod = static_cast<uint32_t>(max(count, 1));
  const uint32_t total_mod = static_cast<uint32_t>(max(total, 1));
  const uint32_t live_mod = static_cast<uint32_t>(max(n_live, 1));
  for (int j = threadIdx.x; j < batch; j += blockDim.x) {
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
  if (threadIdx.x == 0) {
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
  amper::load_ranges(lo, hi, m, s_lo, s_hi);
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= batch) return;  // whole warps leave together
  if (stats[0] == 0) {  // empty CSP: uniform over the live rows
    if (lane == 0) idx[j] = draws[batch + j];
    return;
  }
  const int32_t found = amper::select_member(pq, valid, n, s_lo, s_hi, m,
                                             prefix, nblk, draws[j]);
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
  draw_kernel<<<1, kScanThreads, 0, s>>>(
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
