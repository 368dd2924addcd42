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
// and 0.37 us for one 250,000-row shard on an H100 SXM (3.35 TB/s).  The
// select re-reads at most one 1024-row tile (5 KiB) per rank; at these
// sizes the three launches' fixed cost dominates.
//
// Design: the TPU kernel carried the running member count across its
// sequential grid in SMEM and gathered with one-hot f32 matmuls.  Here
// it is the three launches of the rank-select scheme in common.cuh, on
// one stream: per-tile counts, a one-block scan that also writes
// `count`, and one warp per rank.  Ranks arrive as an int32 device
// tensor, so nothing waits on the host; no atomics, so the result is
// deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using amper::kMaxRanges;
using amper::kScanThreads;
using amper::kThreads;
using amper::kTileRows;

__global__ void count_kernel(const int32_t* __restrict__ pq,
                             const uint8_t* __restrict__ valid, long long n,
                             const int32_t* __restrict__ lo,
                             const int32_t* __restrict__ hi, int m,
                             int32_t* __restrict__ tiles) {
  amper::count_tile(pq, valid, n, lo, hi, m, 0, tiles);
}

__global__ void scan_kernel(const int32_t* __restrict__ tiles, int nblk,
                            int32_t* __restrict__ prefix,
                            int32_t* __restrict__ count) {
  const amper::TileTotals tot = amper::scan_tiles(tiles, nblk, prefix);
  if (threadIdx.x == 0) *count = tot.members;
}

__global__ void select_kernel(const int32_t* __restrict__ pq,
                              const uint8_t* __restrict__ valid, long long n,
                              const int32_t* __restrict__ lo,
                              const int32_t* __restrict__ hi, int m,
                              const int32_t* __restrict__ prefix, int nblk,
                              const int32_t* __restrict__ rank,
                              const int32_t* __restrict__ count, int batch,
                              int32_t* __restrict__ idx) {
  __shared__ int32_t s_lo[kMaxRanges], s_hi[kMaxRanges];
  amper::load_ranges(lo, hi, m, s_lo, s_hi);
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= batch) return;  // whole warps leave together
  const int r = rank[j];
  if (r < 0 || r >= *count) {  // one rank a warp: the warp leaves together
    if (lane == 0) idx[j] = 0;
    return;
  }
  const int32_t found =
      amper::select_member(pq, valid, n, s_lo, s_hi, m, prefix, nblk, r);
  if (lane == 0) idx[j] = found;
}

}  // namespace

// scratch: int32[4 * nblk] with nblk = ceil(n / 1024).  pq must be
// 16-byte and valid 4-byte aligned (common.cuh).  Three launches on
// `stream` (two when batch is 0); returns the first launch error, or 0.
extern "C" int rank_select_launch(const void* pq, const void* valid,
                                  long long n, const void* lo, const void* hi,
                                  int m, const void* rank, int batch,
                                  void* idx, void* count, void* scratch,
                                  void* stream) {
  if (m < 1 || m > kMaxRanges || n < 1 || batch < 0 || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = static_cast<int>((n + kTileRows - 1) / kTileRows);
  int32_t* tiles = static_cast<int32_t*>(scratch);
  int32_t* prefix = tiles + 3 * nblk;
  const int32_t* p = static_cast<const int32_t*>(pq);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int32_t* l = static_cast<const int32_t*>(lo);
  const int32_t* h = static_cast<const int32_t*>(hi);
  int32_t* cnt = static_cast<int32_t*>(count);

  count_kernel<<<nblk, kThreads, 0, s>>>(p, v, n, l, h, m, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, nblk, prefix, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess || batch == 0) return static_cast<int>(err);
  const int warps = kThreads / 32;
  select_kernel<<<(batch + warps - 1) / warps, kThreads, 0, s>>>(
      p, v, n, l, h, m, prefix, nblk, static_cast<const int32_t*>(rank), cnt,
      batch, static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rank_select_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
