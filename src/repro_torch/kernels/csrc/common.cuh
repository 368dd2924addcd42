// Row loads and the m-range test shared by the AMPER-fr kernels.
//
// The wrappers (kernels/ops.py) pass only tables whose pq starts on a
// 16-byte and valid on a 4-byte boundary, as the caching allocator gives
// them, so every whole group of 4 rows is one int4 and one uchar4 load;
// only the ragged tail past the last whole group reads row by row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace amper {

constexpr int kMaxRanges = 64;
constexpr unsigned kFull = 0xffffffffu;

// Loads rows row0 .. row0+3 (row0 a multiple of 4); rows at or past n
// read as invalid.
__device__ __forceinline__ void load4(const int32_t* __restrict__ pq,
                                      const uint8_t* __restrict__ valid,
                                      long long n, long long row0,
                                      int32_t p[4], bool v[4]) {
  if (row0 + 4 <= n) {
    const int4 p4 = *reinterpret_cast<const int4*>(pq + row0);
    const uchar4 v4 = *reinterpret_cast<const uchar4*>(valid + row0);
    p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
    v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = row0 + k < n;
      p[k] = in ? pq[row0 + k] : -1;
      v[k] = in ? valid[row0 + k] != 0 : false;
    }
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
