// Tile loads, conversions and warp reductions shared by the attention
// kernels (flash_attention.cu, decode_attention.cu).
//
// The float32 flash kernel stages its tiles in shared memory through
// load_tiles.  Rows are read as 16-byte chunks (4 floats); the wrappers
// pass contiguous tensors whose rows are a multiple of 8 values and whose
// base is 16-byte aligned, so a chunk never straddles two rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kThreads = 256;        // threads of a float32 flash block
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;    // score of a key the mask hides
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Chunk;  // values in one 16-byte load
template <> struct Chunk<float> { static constexpr int n = 4; };

__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copies rows [row0, row0 + rows) of the row-major [n_rows, d] matrices
// a and b into shared memory as float32, row strides lda and ldb (in
// floats), a's values times scale_a; rows at or past n_rows read as zero
// (so a zero weight times them stays zero).  b may be null.  Each thread
// issues its 16-byte loads two chunks at a time before it stores any, so
// a block keeps 4 loads a thread in flight.
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           int row0, int rows, int n_rows,
                                           int d, float scale_a,
                                           float* __restrict__ sa, int lda,
                                           float* __restrict__ sb, int ldb) {
  constexpr int V = Chunk<T>::n;
  const int per_row = d / V;
  const int total = rows * per_row;
  for (int c0 = threadIdx.x; c0 < total; c0 += 2 * kThreads) {
    float va[2][V], vb[2][V];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * kThreads;
      const int r = c / per_row;
      const int col = (c - r * per_row) * V;
      const bool live = c < total && row0 + r < n_rows;
      const long long off = static_cast<long long>(row0 + r) * d + col;
      if (live) {
        load16(a + off, va[u]);
        if (b != nullptr) load16(b + off, vb[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) va[u][i] = vb[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * kThreads;
      if (c >= total) break;
      const int r = c / per_row;
      const int col = (c - r * per_row) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) sa[r * lda + col + i] = va[u][i] * scale_a;
      if (b != nullptr) {
#pragma unroll
        for (int i = 0; i < V; ++i) sb[r * ldb + col + i] = vb[u][i];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

}  // namespace attn
