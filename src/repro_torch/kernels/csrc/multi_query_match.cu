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
// an H100 SXM (3.35 TB/s).  The m compares a row are a handful of integer
// operations, far below the card's integer rate, so at n = 1e6 the launch
// itself (a few us) dominates.
//
// Design: one launch over the flat table, with no padding to 128 lanes;
// the ragged tail is masked here.  Each thread takes 4 consecutive rows
// with one int4 load of pq and one uchar4 load of valid (common.cuh;
// scalar loads only for the ragged tail), tests the m ranges held in shared
// memory and writes sel as one uchar4 (store4).  Per-range counts are
// summed in a warp (__reduce_add_sync), then across the block's warps in
// shared memory, then with one integer atomicAdd per range per block.  Integer
// addition is associative, so the counts do not depend on block order
// (the TPU kernel relied on its sequential grid instead).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using amper::kFull;
using amper::kMaxRanges;
using amper::kRowsPerThread;
using amper::kThreads;
using amper::load4;

__global__ void multi_query_match_kernel(
    const int32_t* __restrict__ pq, const uint8_t* __restrict__ valid,
    long long n, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, int m, uint8_t* __restrict__ sel,
    int32_t* __restrict__ counts) {
  __shared__ int32_t s_lo[kMaxRanges];
  __shared__ int32_t s_hi[kMaxRanges];
  __shared__ int32_t s_cnt[kMaxRanges];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
    s_cnt[i] = 0;
  }
  __syncthreads();

  const long long row0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kRowsPerThread;
  int32_t p[kRowsPerThread];
  bool v[kRowsPerThread];
  load4(pq, valid, n, row0, p, v);

  bool s[kRowsPerThread] = {false, false, false, false};
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < m; ++i) {
    const int32_t a = s_lo[i], b = s_hi[i];
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const bool hit = v[k] && p[k] >= a && p[k] <= b;
      s[k] |= hit;
      c += hit;
    }
    c = __reduce_add_sync(kFull, c);
    if (lane == 0 && c) atomicAdd(&s_cnt[i], static_cast<int32_t>(c));
  }

  amper::store4(sel, n, row0, s);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    if (s_cnt[i]) atomicAdd(&counts[i], s_cnt[i]);
}

}  // namespace

// counts must hold m zeros on entry.  pq must be 16-byte and valid and
// sel 4-byte aligned (common.cuh).
extern "C" int multi_query_match_launch(
    const void* pq, const void* valid, long long n, const void* lo,
    const void* hi, int m, void* sel, void* counts, void* stream) {
  if (m < 1 || m > kMaxRanges || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long threads = (n + kRowsPerThread - 1) / kRowsPerThread;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  multi_query_match_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pq), static_cast<const uint8_t*>(valid), n,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi), m,
      static_cast<uint8_t*>(sel), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* multi_query_match_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
