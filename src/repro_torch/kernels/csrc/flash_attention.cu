// Blockwise (flash) attention forward, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:30
// (_flash_fwd_kernel, called through flash_attention_fwd at :72).  Same
// function as the port's kernels/ref.py::attention_ref:
//
//   out[b, h] = softmax(mask(q[b, h] k[b, h / group]^T / sqrt(D))) v[b, h / group]
//
// with q [B, Hq, S, D], k and v [B, Hkv, S, D], group = Hq / Hkv (GQA and
// MQA through the kv-head map, no broadcast of k or v), a causal mask
// (qpos >= kpos) and a sliding window (qpos - kpos < window), each
// optional.  float32 or bfloat16 in, float32 arithmetic, output in q's
// type.
//
// Bound: at the serving path's prefill shape (B 4, H 32, S 1024, D 64,
// bf16, causal) the inputs and the output are 67 MB, 20 us at 3.35 TB/s,
// and the causal half of the two products is 17 GFLOP, 17 us on the
// tensor cores: the two are close.  This kernel does its products on the
// float32 cores from shared memory, so it is bound by operations and by
// shared-memory reads, far above either figure; tensor cores (wgmma) and
// TMA loads are the next step.
//
// Design: the TPU kernel's grid (b, h, q tile, kv tile) ran the kv tiles
// in order on one core and carried the running (max, denominator,
// accumulator) in scratch between grid steps.  CUDA blocks run in no
// order, so one block takes one (b, q head, 64-row q tile) and sweeps
// its kv tiles in a loop, carrying the running state in registers:
//   * the q tile (scaled by 1/sqrt(D) in float32, as the TPU kernel
//     scales it) and each 64-row k and v tile are staged in shared
//     memory as float32, k and q with a row stride of D + 1 so that
//     lanes reading different rows hit different banks;
//   * scores: each thread computes a 4 x 4 block of the 64 x 64 tile
//     (rows tr + 16a, keys tj + 16b), then masks it: -1e30 where the
//     causal or window mask hides the key (as the TPU kernel), -inf past
//     the end of S (a padded key that must weigh nothing);
//   * softmax: warp w owns q rows 8w .. 8w + 7: it reduces each row's
//     maximum with shuffles, turns the scores into weights in place and
//     keeps each row's (max, denominator) in registers;
//   * p v: the same warp adds its rows' weights times v into a float32
//     accumulator, lane l holding columns l, l + 32, ... (NC of them);
//   * at the end each row is divided by max(denominator, 1e-30).
// kv tiles that the causal or window geometry hides from the whole q
// tile are skipped (the same function: they would weigh nothing), and
// the blocks of the longest sweeps are launched first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

using attn::kMasked;
using attn::kThreads;

constexpr int kBQ = 64;    // q rows of a block
constexpr int kBKV = 64;   // keys of a kv tile
constexpr int kRows = kBQ / attn::kWarps;  // q rows of a warp (8)
constexpr int kLdP = kBKV + 1;             // row stride of the score tile

size_t smem_bytes(int d) {
  const size_t ld = d + 1;
  return sizeof(float) * (kBQ * ld + kBKV * ld + kBKV * d + kBQ * kLdP);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int s_len, int d, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;              // [kBQ][ld], scaled
  float* ks = qs + kBQ * ld;     // [kBKV][ld]
  float* vs = ks + kBKV * ld;    // [kBKV][d]
  float* ps = vs + kBKV * d;     // [kBQ][kLdP]: scores, then weights

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest sweeps first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const long long q_off = (static_cast<long long>(b) * hq + h) * s_len * d;
  const long long kv_off = (static_cast<long long>(b) * hkv + hk) * s_len * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  attn::load_tiles<T>(q + q_off, nullptr, q0, kBQ, s_len, d, scale, qs, ld,
                      nullptr, 0);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that some row of this q tile can see
  const int q_last = min(q0 + kBQ, s_len) - 1;
  int kt_hi = (s_len + kBKV - 1) / kBKV;
  if (causal) kt_hi = min(kt_hi, q_last / kBKV + 1);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBKV : 0;

  const int tr = tid / 16, tj = tid % 16;  // score block of this thread
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // the last tile's readers are done
    attn::load_tiles<T>(k + kv_off, v + kv_off, k0, kBKV, s_len, d, 1.f, ks,
                        ld, vs, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int x = 0; x < d; ++x) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(tr + 16 * a) * ld + x];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tj + 16 * c) * ld + x];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = tr + 16 * a, j = tj + 16 * c;
        const int qpos = q0 + r, kpos = k0 + j;
        float x = s[a][c];
        if (kpos >= s_len) {
          x = -INFINITY;
        } else if ((causal && qpos < kpos) ||
                   (window > 0 && qpos - kpos >= window)) {
          x = kMasked;
        }
        ps[r * kLdP + j] = x;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float* row = ps + (warp * kRows + i) * kLdP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_new = fmaxf(m[i], attn::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + attn::warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBKV; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < d ? vs[j * d + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(warp * kRows + i) * kLdP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + warp * kRows + i;
    if (qpos >= s_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = o + q_off + static_cast<long long>(qpos) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) attn::store(out + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o,
              int batch, int hq, int hkv, int s_len, int d, int causal,
              int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NC>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kBQ - 1) / kBQ, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s_len, d,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, void* o,
                int batch, int hq, int hkv, int s_len, int d, int causal,
                int window, float scale, cudaStream_t stream) {
#define FLASH_NC(NC)                                                       \
  case NC:                                                                 \
    return launch_nc<T, NC>(q, k, v, o, batch, hq, hkv, s_len, d, causal, \
                            window, scale, stream);
  switch ((d + 31) / 32) {
    FLASH_NC(1) FLASH_NC(2) FLASH_NC(3) FLASH_NC(4)
    FLASH_NC(5) FLASH_NC(6) FLASH_NC(7) FLASH_NC(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_NC
}

}  // namespace

// q [batch, hq, s_len, d], k and v [batch, hkv, s_len, d], o like q: all
// contiguous, 16-byte aligned, of one type (bf16 != 0: bfloat16, else
// float32).  d is a multiple of 8 in [8, 256], hq a multiple of hkv;
// window <= 0 means no window.  scale is 1/sqrt(d) in float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int hq, int hkv, int s_len, int d,
                                      int causal, int window, float scale,
                                      int bf16, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || s_len < 1 || d < 8 ||
      d > 256 || d % 8 || hq > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_type<__nv_bfloat16>(q, k, v, o, batch, hq, hkv, s_len, d,
                                      causal, window, scale, st);
  return launch_type<float>(q, k, v, o, batch, hq, hkv, s_len, d, causal,
                            window, scale, st);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
