// Row loads, stores and constants shared by the replay kernels.
//
// The wrappers (kernels/ops.py) pass only tables whose pq starts on a
// 16-byte and valid on a 4-byte boundary, as the caching allocator gives
// them, so every whole group of 4 rows is one int4 and one uchar4 load;
// only the ragged tail past the last whole group reads row by row.
// tcam_match.cu and the one-launch kernels' tiles (onepass.cuh) load rows
// through here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace amper {

constexpr int kMaxRanges = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;       // threads of a tcam_match block
constexpr int kRowsPerThread = 4;

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

}  // namespace amper
