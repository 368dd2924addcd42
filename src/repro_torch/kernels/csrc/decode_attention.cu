// Single-position (decode) attention over a KV cache, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:28
// (_decode_kernel, called through decode_attention_fwd at :61).  Same
// function as the port's kernels/ref.py::decode_attention_ref:
//
//   out[b, h, g] = softmax(q[b, h, g] k[b, h]^T / sqrt(D), keys < cur_len) v[b, h]
//
// with q [B, Hkv, group, D] (the group query heads of kv head h), k and v
// [B, Hkv, S, D], and cur_len an int32 in device memory, read by the
// kernel as the TPU kernel reads its (1,) operand, so a decode step never
// waits on the host for it.  float32 or bfloat16 in, float32 arithmetic,
// output in q's type.
//
// Bound: bytes.  A step must read the cur_len live rows of k and v once:
// at the serving path's shape (B 4, Hkv 32, group 1, D 64, bf16) that is
// 33.5 MB at cur_len 1024, 10 us at 3.35 TB/s; the products are 2 flops
// a byte, far below the card's rate.
//
// Design: one block per (b, kv head), as the TPU grid's (b, h) axes, with
// the cache sweep as a loop inside the block (nothing carries between
// blocks).  Each kv tile (128 keys, or 64 for D > 128) is loaded once,
// coalesced, into shared memory as float32 (k with a row stride of D + 1
// so lanes reading different keys hit different banks), and serves every
// query head of the group from there: the TPU design's point, which
// matters for MQA (group 8) and GQA (group 4).  Per tile:
//   * scores: thread t takes (g, key) pairs t, t + 256, ...; keys at or
//     past cur_len score -1e30 (as the TPU kernel), keys past S -inf;
//   * softmax: warp w updates rows g = w, w + 8, ... (running max and
//     denominator in shared memory) and turns the scores into weights;
//   * p v: the group's G x D outputs are spread over the block; when
//     they are fewer than 256, the block splits into 256 / (G D) groups
//     of threads that take every other key, so all threads work, and
//     their partial sums (rescaled by the same factors) are added at the
//     end.
// Tiles that hold no key below cur_len are skipped (the same function:
// their weights are 0), unless no key is live at all (cur_len <= 0),
// where every key is masked and the weights are uniform, as in the plain
// version.  At B Hkv = 128 blocks the card's 132 SMs hold one block each;
// MQA at small batch fills few SMs, which a split of the cache across
// blocks (split-KV) would fix in a later kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

using attn::kMasked;
using attn::kThreads;
using attn::kWarps;

constexpr int kMaxOuts = 16 * kThreads;  // group * D a block can hold

size_t smem_floats(int group, int d, int bkv) {
  return static_cast<size_t>(group) * d + static_cast<size_t>(bkv) * (d + 1) +
         static_cast<size_t>(bkv) * d + static_cast<size_t>(group) * bkv +
         3 * static_cast<size_t>(group);
}

template <typename T, int PER>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ cur_len,
                        T* __restrict__ o, int group, int s_len, int d,
                        int bkv, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                   // [group][d], scaled
  float* ks = qs + group * d;         // [bkv][ld]
  float* vs = ks + bkv * ld;          // [bkv][d]
  float* ps = vs + bkv * d;           // [group][bkv]: scores, then weights
  float* m_run = ps + group * bkv;    // [group] running max
  float* l_run = m_run + group;       // [group] running denominator
  float* alpha = l_run + group;       // [group] this tile's rescale

  const int h = blockIdx.x, b = blockIdx.y, hkv = gridDim.x;
  const long long bh = static_cast<long long>(b) * hkv + h;
  const T* kp = k + bh * s_len * d;
  const T* vp = v + bh * s_len * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int cur = *cur_len;
  const int live = min(cur, s_len);
  const int n_tiles = ((live > 0 ? live : s_len) + bkv - 1) / bkv;

  attn::load_tiles<T>(q + bh * group * d, nullptr, 0, group, group, d, scale,
                      qs, d, nullptr, 0);
  for (int g = tid; g < group; g += kThreads) {
    m_run[g] = kMasked;
    l_run[g] = 0.f;
  }

  // Outputs owned by this thread: idx = base + span * p, p < PER.
  const int outs = group * d;
  const int span = outs < kThreads ? outs : kThreads;
  const int n_split = kThreads / span;     // groups splitting the keys
  const int split = tid / span, base = tid % span;
  const bool active = split < n_split;
  int og[PER], od[PER];
  float acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int idx = base + span * p;
    og[p] = idx < outs ? idx / d : -1;
    od[p] = idx < outs ? idx % d : 0;
    acc[p] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * bkv;
    __syncthreads();  // the last tile's readers are done
    attn::load_tiles<T>(kp, vp, k0, bkv, s_len, d, 1.f, ks, ld, vs, d);
    __syncthreads();

    for (int e = tid; e < group * bkv; e += kThreads) {
      const int g = e / bkv, j = e - g * bkv;
      const float* qr = qs + g * d;
      const float* kr = ks + j * ld;
      float s = 0.f;
#pragma unroll 8
      for (int x = 0; x < d; ++x) s = fmaf(qr[x], kr[x], s);
      const int kpos = k0 + j;
      ps[e] = kpos >= s_len ? -INFINITY : (kpos < cur ? s : kMasked);
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      float* row = ps + g * bkv;
      float mt = -INFINITY;
      for (int j = lane; j < bkv; j += 32) mt = fmaxf(mt, row[j]);
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, attn::warp_max(mt));
      float sum = 0.f;
      for (int j = lane; j < bkv; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l_run[g] = a * l_run[g] + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    if (active) {
#pragma unroll
      for (int p = 0; p < PER; ++p)
        if (og[p] >= 0) acc[p] *= alpha[og[p]];
      for (int j = split; j < bkv; j += n_split) {
#pragma unroll
        for (int p = 0; p < PER; ++p)
          if (og[p] >= 0)
            acc[p] = fmaf(ps[og[p] * bkv + j], vs[j * d + od[p]], acc[p]);
      }
    }
  }

  T* out = o + bh * group * d;
  if (n_split > 1) {
    __syncthreads();  // ks is free: it takes the partial sums
    float* part = ks;  // [n_split][outs]
    if (active) part[split * outs + base] = acc[0];
    __syncthreads();
    if (tid < outs) {
      float sum = 0.f;
      for (int s = 0; s < n_split; ++s) sum += part[s * outs + tid];
      attn::store(out + tid, sum / fmaxf(l_run[tid / d], 1e-30f));
    }
  } else {
#pragma unroll
    for (int p = 0; p < PER; ++p)
      if (og[p] >= 0)
        attn::store(out + og[p] * d + od[p],
                    acc[p] / fmaxf(l_run[og[p]], 1e-30f));
  }
}

template <typename T, int PER>
int launch_per(const void* q, const void* k, const void* v,
               const void* cur_len, void* o, int batch, int hkv, int group,
               int s_len, int d, int bkv, size_t smem, float scale,
               cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, PER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(hkv, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(cur_len),
      static_cast<T*>(o), group, s_len, d, bkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v,
                const void* cur_len, void* o, int batch, int hkv, int group,
                int s_len, int d, int bkv, size_t smem, float scale,
                cudaStream_t stream) {
  const int per = (group * d + kThreads - 1) / kThreads;
#define DECODE_PER(P)                                                    \
  if (per <= P)                                                          \
    return launch_per<T, P>(q, k, v, cur_len, o, batch, hkv, group,      \
                            s_len, d, bkv, smem, scale, stream);
  DECODE_PER(1) DECODE_PER(2) DECODE_PER(4) DECODE_PER(8) DECODE_PER(16)
#undef DECODE_PER
  return cudaErrorInvalidValue;
}

}  // namespace

// q [batch, hkv, group, d], k and v [batch, hkv, s_len, d], o like q: all
// contiguous, 16-byte aligned, of one type (bf16 != 0: bfloat16, else
// float32); cur_len points at one int32 on the device.  d is a multiple
// of 8 in [8, 256] and group * d <= 4096.  scale is 1/sqrt(d) in float32.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cur_len,
                                       void* o, int batch, int hkv,
                                       int group, int s_len, int d,
                                       float scale, int bf16, void* stream) {
  if (batch < 1 || hkv < 1 || group < 1 || s_len < 1 || d < 8 || d > 256 ||
      d % 8 || group * d > kMaxOuts || batch > 65535)
    return cudaErrorInvalidValue;
  // 128-key tiles while they fit in 200 KB of shared memory, else 64
  int bkv = d <= 128 ? 128 : 64;
  if (smem_floats(group, d, bkv) * sizeof(float) > 200 * 1024) bkv = 64;
  const size_t smem = smem_floats(group, d, bkv) * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_type<__nv_bfloat16>(q, k, v, cur_len, o, batch, hkv, group,
                                      s_len, d, bkv, smem, scale, st);
  return launch_type<float>(q, k, v, cur_len, o, batch, hkv, group, s_len, d,
                            bkv, smem, scale, st);
}

extern "C" const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
