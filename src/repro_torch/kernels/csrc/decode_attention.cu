// Single-position (decode) attention over a KV cache, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:28
// (_decode_kernel, called through decode_attention_fwd at :61).  Same
// function as the port's kernels/ref.py::decode_attention_ref:
//
//   out[b, h, g] = softmax(q[b, h, g] k[b, h]^T / sqrt(D), keys live) v[b, h]
//
// with q [B, Hkv, group, D] (the group query heads of kv head h), k
// [B, Hkv, S, D], v [B, Hkv, S, Dv] (Dv may differ from D: MLA scores
// over 192 columns and averages 128), and cur_len an int32 in device
// memory, read by the kernel as the TPU kernel reads its (1,) operand, so
// a decode step never waits on the host for it.  The live keys are those
// below cur_len and, with a sliding window W (a launch argument, the same
// for every call of a model), at or above cur_len - W: the reference's
// mask (qpos - kpos) < W at qpos = cur_len - 1.  float32 or bfloat16 in,
// float32 arithmetic, output in q's type.  Any group and any head dims
// the wrappers take.
//
// Bound: bytes.  A step must read the live rows of k and v once: at the
// serving path's shape (B 4, Hkv 32, group 1, D 64, bf16) that is 35.7 MB
// at cur_len 1088, 11 us at 3.35 TB/s; the products are 2 flops a byte
// for group 1, far below the card's rate, so there are no tensor cores
// here: the work is keeping enough 16-byte loads in flight on every SM.
//
// Design: split-KV in one launch.  The grid is (kv split, kv head x group
// tile, batch); the wrapper picks the split count from S and the shapes
// (never from cur_len, which stays on the card) so that the card gets
// about four blocks of 128 threads an SM (serving shape: 5 splits of 224
// keys, 640 blocks).  A group tile holds up to 8 query heads (4 in
// float32); a larger group (MQA: 48 heads on one kv head) is spread over
// several tiles, each reading the cache chunk again (mostly from L2).  In
// a block:
//   * each warp takes its own keys, with lanes across max(D, Dv) in
//     16-byte loads (D 64 bf16: 8 lanes a key, 4 keys a warp-load), two
//     warp-loads a step, and the next step's loads in flight during this
//     step's math (registers, double buffered; the first step's are
//     issued before cur_len is read); no block barrier in the sweep;
//   * each key slot of a warp keeps its own running (max, sum,
//     accumulator) per query head in registers, in log2 units (q is
//     scaled by log2(e) / sqrt(D) on its load);
//   * slots merge by shuffles and warps through shared memory, once, at
//     the end; the block writes its float32 partial (max, sum,
//     accumulator[group][Dv]) to scratch;
//   * the last block of each (b, kv head, group tile) to finish (a
//     __threadfence and an atomicAdd on a per-tile counter, which it
//     resets to 0) merges the splits and writes the output, divided by
//     max(sum, 1e-30).  With one split the block writes the output itself.
// Keys outside the live span are left out (the TPU kernel scores them
// -1e30, which weighs 0 beside any live key): a split wholly past cur_len
// or wholly below the window's lower bound writes an empty partial (max
// -inf, sum 0), and a split the bound crosses starts its sweep at the
// step that holds the bound (its preloaded first step is then loaded
// again).  The bound comes from cur_len on the card, so a call never
// syncs and the split count does not depend on it.  If no key is live
// (cur_len <= 0) every key of S scores -1e30 and the weights are
// uniform, as in the plain version.  The scratch and the counters are the
// wrapper's (allocated once per device and size); the kernel allocates
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

using attn::kMasked;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 64;  // splits of a call (the wrapper's cap)
constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Vec;  // values in a 16-byte load, chunks a lane
template <> struct Vec<float> { static constexpr int n = 4, chunks = 2; };
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8, chunks = 1;
};

__device__ __forceinline__ void to_float(const uint4& r, float* out, float*) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void to_float(const uint4& r, float* out,
                                         __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// exp2(m - big), 0 for an empty state (m = -inf)
__device__ __forceinline__ float weight(float m, float big) {
  return m == -INFINITY ? 0.f : exp2f(m - big);
}

// The k and v chunks of this lane for the U keys key0 + u kpw (zeros at
// or past end, or past D for k and Dv for v).
template <typename T, int CM, int U>
__device__ __forceinline__ void load_keys(uint4 (&kr)[U][CM],
                                          uint4 (&vr)[U][CM],
                                          const T* __restrict__ kp,
                                          const T* __restrict__ vp, int key0,
                                          int kpw, int end, int d, int dv,
                                          const int (&col)[CM],
                                          const int (&colv)[CM]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int key = key0 + u * kpw;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      kr[u][c] = key < end && col[c] >= 0
                     ? __ldg(reinterpret_cast<const uint4*>(
                           kp + static_cast<long long>(key) * d + col[c]))
                     : make_uint4(0, 0, 0, 0);
      vr[u][c] = key < end && colv[c] >= 0
                     ? __ldg(reinterpret_cast<const uint4*>(
                           vp + static_cast<long long>(key) * dv + colv[c]))
                     : make_uint4(0, 0, 0, 0);
    }
  }
}

// GT: query heads of a group tile.  `lanes` lanes share a key (a power of
// two covering max(D, Dv) / V chunks, at most 32, each lane holding up to
// CM).  window <= 0: no window.
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ cur_len,
                       T* __restrict__ o, float* __restrict__ part,
                       int* __restrict__ counters, int group, int s_len,
                       int d, int dv, int window, int chunk, int lanes,
                       float scale_log2) {
  constexpr int V = Vec<T>::n, CM = Vec<T>::chunks;
  constexpr int U = 2;  // keys a slot takes a step
  __shared__ float sm_acc[kWarps][GT][kMaxD];
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];
  __shared__ float sm_wt[kWarps][GT], sm_big[GT], sm_sum[GT];
  __shared__ int sm_last;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_gt = (group + GT - 1) / GT;
  const int h = blockIdx.y / n_gt, gtile = blockIdx.y % n_gt;
  const int hkv = gridDim.y / n_gt, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * hkv + h;
  const int g0 = gtile * GT, gact = min(GT, group - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kpw = 32 / lanes, slot = lane / lanes;
  int col[CM], colv[CM];  // this lane's k and v columns (-1: none)
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    const int j = c * lanes + lane % lanes;
    col[c] = j < d / V ? j * V : -1;
    colv[c] = j < dv / V ? j * V : -1;
  }

  const int c0 = split * chunk;
  const T* kp = k + bh * s_len * d;
  const T* vp = v + bh * s_len * dv;
  // The first step's loads go out before cur_len is known: keys of the
  // chunk below S are in bounds, and those outside the live span are
  // dropped by the step's masks.
  const int step_keys = kWarps * U * kpw;
  const int first = c0 + warp * U * kpw + slot;
  uint4 kc[U][CM], vc[U][CM], kn[U][CM], vn[U][CM];
  load_keys<T, CM, U>(kc, vc, kp, vp, first, kpw, min(c0 + chunk, s_len), d,
                      dv, col, colv);
  const int cur = *cur_len;
  const bool none_live = cur <= 0;  // every key masked: uniform weights
  const int live = none_live ? s_len : min(cur, s_len);
  const int end = min(c0 + chunk, live);
  // the window's lower bound (0 when no key is live: uniform over S)
  const int lo = window > 0 && !none_live ? max(0, cur - window) : 0;
  // the sweep's first step: the one that holds max(c0, lo)
  const int t0 = lo > c0 ? (lo - c0) / step_keys : 0;
  if (t0 > 0 && c0 + t0 * step_keys < end)
    load_keys<T, CM, U>(kc, vc, kp, vp, first + t0 * step_keys, kpw, end, d,
                        dv, col, colv);

  float qf[GT][CM][V];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (g < gact && col[c] >= 0) {
        const uint4 r = *reinterpret_cast<const uint4*>(
            q + (bh * group + g0 + g) * d + col[c]);
        to_float(r, qf[g][c], static_cast<T*>(nullptr));
#pragma unroll
        for (int i = 0; i < V; ++i) qf[g][c][i] *= scale_log2;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) qf[g][c][i] = 0.f;
      }
    }

  float m[GT], l[GT], acc[GT][CM][V];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[g][c][i] = 0.f;
  }

  // The sweep: at step t, warp w takes keys first + t step_keys + u kpw
  // (u < U) in its slot, the next step's loads in flight meanwhile.
  const int n_steps =
      end > max(c0, lo) ? (end - c0 + step_keys - 1) / step_keys : 0;
  for (int t = t0; t < n_steps; ++t) {
    const int key0 = first + t * step_keys;
    if (t + 1 < n_steps)
      load_keys<T, CM, U>(kn, vn, kp, vp, key0 + step_keys, kpw, end, d, dv,
                          col, colv);
    float kf[U][CM][V], vf[U][CM][V];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = key0 + u * kpw < end && key0 + u * kpw >= lo;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        to_float(kc[u][c], kf[u][c], static_cast<T*>(nullptr));
        to_float(vc[u][c], vf[u][c], static_cast<T*>(nullptr));
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= gact) break;
      float x[U];
      float big = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CM; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i) dot = fmaf(qf[g][c][i], kf[u][c][i], dot);
        for (int off = 1; off < lanes; off <<= 1)
          dot += __shfl_xor_sync(attn::kFull, dot, off);
        x[u] = none_live ? kMasked : dot;
        if (ok[u]) big = fmaxf(big, x[u]);
      }
      if (big == -INFINITY) continue;  // no key of this slot yet
      const float a = weight(m[g], big);
      m[g] = big;
      l[g] *= a;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[u] = ok[u] ? exp2f(x[u] - big) : 0.f;
        l[g] += x[u];
      }
#pragma unroll
      for (int c = 0; c < CM; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float y = acc[g][c][i] * a;
#pragma unroll
          for (int u = 0; u < U; ++u) y = fmaf(x[u], vf[u][c][i], y);
          acc[g][c][i] = y;
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        kc[u][c] = kn[u][c];
        vc[u][c] = vn[u][c];
      }
  }

  // Merge the key slots of the warp (lanes `lanes` apart), then the warps.
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(attn::kFull, m[g], off);
      const float lo = __shfl_xor_sync(attn::kFull, l[g], off);
      const float big = fmaxf(m[g], mo);
      const float a = weight(m[g], big), bo = weight(mo, big);
      m[g] = big;
      l[g] = l[g] * a + lo * bo;
#pragma unroll
      for (int c = 0; c < CM; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float ao = __shfl_xor_sync(attn::kFull, acc[g][c][i], off);
          acc[g][c][i] = acc[g][c][i] * a + ao * bo;
        }
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < CM; ++c)
        if (colv[c] >= 0)
#pragma unroll
          for (int i = 0; i < V; ++i)
            sm_acc[warp][g][colv[c] + i] = acc[g][c][i];
    }
  }
  __syncthreads();
  if (threadIdx.x < GT) {
    const int g = threadIdx.x;
    float big = -INFINITY;
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, sm_m[w][g]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sm_wt[w][g] = weight(sm_m[w][g], big);
      sum += sm_l[w][g] * sm_wt[w][g];
    }
    sm_big[g] = big;
    sm_sum[g] = sum;
  }
  __syncthreads();

  T* out = o + (bh * group + g0) * dv;
  if (n_split == 1) {
    for (int idx = threadIdx.x; idx < gact * dv; idx += kThreads) {
      const int g = idx / dv, e = idx - g * dv;
      float a = 0.f;
      for (int w = 0; w < kWarps; ++w) a += sm_acc[w][g][e] * sm_wt[w][g];
      attn::store(out + idx, a / fmaxf(sm_sum[g], 1e-30f));
    }
    return;
  }

  // This split's partial: [max, sum, acc[Dv]] per query head.
  const int rec = dv + 2;
  float* mine = part + (bh * group + g0) * n_split * rec;
  for (int idx = threadIdx.x; idx < gact * dv; idx += kThreads) {
    const int g = idx / dv, e = idx - g * dv;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][g][e] * sm_wt[w][g];
    mine[(g * n_split + split) * rec + 2 + e] = a;
  }
  if (threadIdx.x < gact) {
    mine[(threadIdx.x * n_split + split) * rec] = sm_big[threadIdx.x];
    mine[(threadIdx.x * n_split + split) * rec + 1] = sm_sum[threadIdx.x];
  }
  // Publish the partial: the block's writes, then one device-scope fence
  // and the count (release); the last block fences again before it reads
  // (acquire).
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + bh * n_gt + gtile;
    __threadfence();
    sm_last = atomicAdd(cnt, 1) == n_split - 1;
    if (sm_last) *cnt = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();

  // The last block merges the splits, each output in one pass over them
  // (the loads of several splits in flight at once).
  for (int idx = threadIdx.x; idx < gact * dv; idx += kThreads) {
    const int g = idx / dv, e = idx - g * dv;
    const float* pg = mine + g * n_split * rec;
    float big = -INFINITY, den = 0.f, num = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp) {
      const float ms = __ldcg(pg + sp * rec);
      const float ls = __ldcg(pg + sp * rec + 1);
      const float as = __ldcg(pg + sp * rec + 2 + e);
      if (ms == -INFINITY) continue;  // a split outside the live span
      const float nb = fmaxf(big, ms);
      const float a = weight(big, nb), w = exp2f(ms - nb);
      den = den * a + ls * w;
      num = num * a + as * w;
      big = nb;
    }
    attn::store(out + idx, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int GT>
int launch_gt(const void* q, const void* k, const void* v,
              const void* cur_len, void* o, void* part, void* counters,
              int batch, int hkv, int group, int s_len, int d, int dv,
              int window, int n_split, int chunk, float scale,
              cudaStream_t stream) {
  const int n_chunks = max(d, dv) / Vec<T>::n;
  int lanes = 1;
  while (lanes < n_chunks && lanes < 32) lanes <<= 1;
  const int n_gt = (group + GT - 1) / GT;
  if (static_cast<long long>(hkv) * n_gt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n_split, hkv * n_gt, batch);
  decode_attention_split<T, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(cur_len),
      static_cast<T*>(o), static_cast<float*>(part),
      static_cast<int*>(counters), group, s_len, d, dv, window, chunk, lanes,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v,
                const void* cur_len, void* o, void* part, void* counters,
                int batch, int hkv, int group, int s_len, int d, int dv,
                int window, int n_split, int chunk, int gt, float scale,
                cudaStream_t stream) {
#define DECODE_GT(G)                                                       \
  case G:                                                                  \
    return launch_gt<T, G>(q, k, v, cur_len, o, part, counters, batch, hkv, \
                           group, s_len, d, dv, window, n_split, chunk,     \
                           scale, stream);
  switch (gt) {
    DECODE_GT(1) DECODE_GT(2) DECODE_GT(4)
    default:
      break;
  }
  // 8 float32 heads' q and accumulators would not fit the registers
  if constexpr (sizeof(T) == 2) {
    if (gt == 8)
      return launch_gt<T, 8>(q, k, v, cur_len, o, part, counters, batch, hkv,
                             group, s_len, d, dv, window, n_split, chunk,
                             scale, stream);
  }
  return cudaErrorInvalidValue;
#undef DECODE_GT
}

}  // namespace

// q [batch, hkv, group, d], k [batch, hkv, s_len, d], v [batch, hkv,
// s_len, dv], o [batch, hkv, group, dv]: all contiguous, 16-byte aligned,
// of one type (bf16 != 0: bfloat16, else float32); cur_len points at one
// int32 on the device.  d and dv are multiples of 8 in [8, 256]; window
// <= 0 means no window; gt (query heads of a group tile) is 1, 2, 4 or
// (bf16 only) 8.  The keys are cut into n_split chunks of `chunk` (1 <=
// n_split <= 64, the last chunk ending at or past s_len).  With n_split >
// 1, part holds batch * hkv * group * n_split * (dv + 2) floats and
// counters batch * hkv * ceil(group / gt) ints that are 0 (the kernel
// leaves them 0).  scale is 1/sqrt(d) in float32.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* cur_len,
                                       void* o, void* part, void* counters,
                                       int batch, int hkv, int group,
                                       int s_len, int d, int dv, int window,
                                       int n_split, int chunk, int gt,
                                       float scale, int bf16, void* stream) {
  if (batch < 1 || hkv < 1 || group < 1 || s_len < 1 || d < 8 || d > kMaxD ||
      d % 8 || dv < 8 || dv > kMaxD || dv % 8 || batch > 65535 ||
      n_split < 1 || n_split > kMaxSplits ||
      chunk < 1 || static_cast<long long>(n_split) * chunk < s_len ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_type<__nv_bfloat16>(q, k, v, cur_len, o, part, counters,
                                      batch, hkv, group, s_len, d, dv,
                                      window, n_split, chunk, gt, scale, st);
  return launch_type<float>(q, k, v, cur_len, o, part, counters, batch, hkv,
                            group, s_len, d, dv, window, n_split, chunk, gt,
                            scale, st);
}

extern "C" const char* decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
