// One ternary (TCAM) query over the flat priority table, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/tcam_match.py:38
// (tcam_match_kernel, called through tcam_match at :46).  Same function
// as the port's kernels/ref.py::tcam_match_ref:
//
//   out[r] = ((pq[r] ^ query) & ~mask) == 0
//
// Bound: bytes.  Each row is read once (4 B of pq) and its flag written
// once (1 B): 5 B a row, about 1.5 us at n = 1e6 on an H100 SXM
// (3.35 TB/s).  Three integer operations a row are far below the card's
// integer rate, so at n = 1e6 the launch itself dominates.
//
// Design: the TPU kernel streamed (block_rows, 128) tiles of a padded
// table.  Here one launch covers the flat table with no padding: each
// thread takes 4 consecutive rows with one int4 load and writes their
// flags as one uchar4 (load4 / store4 in common.cuh); only the ragged
// tail goes row by row.  query and mask are read from device memory, so
// a query computed on the card needs no host sync.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using amper::kRowsPerThread;
using amper::kThreads;

__global__ void tcam_match_kernel(const int32_t* __restrict__ pq, long long n,
                                  const int32_t* __restrict__ query,
                                  const int32_t* __restrict__ mask,
                                  uint8_t* __restrict__ out) {
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kRowsPerThread;
  if (row0 >= n) return;
  const int32_t q = *query, keep = ~*mask;
  int32_t p[kRowsPerThread];
  amper::load4(pq, n, row0, p);
  bool s[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) s[k] = ((p[k] ^ q) & keep) == 0;
  amper::store4(out, n, row0, s);
}

}  // namespace

// pq must be 16-byte and out 4-byte aligned (common.cuh); query and mask
// point at one int32 each on the device.
extern "C" int tcam_match_launch(const void* pq, long long n,
                                 const void* query, const void* mask,
                                 void* out, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long threads = (n + kRowsPerThread - 1) / kRowsPerThread;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  tcam_match_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pq), n, static_cast<const int32_t*>(query),
      static_cast<const int32_t*>(mask), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tcam_match_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
