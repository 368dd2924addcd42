// Blockwise (flash) attention forward, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:30
// (_flash_fwd_kernel, called through flash_attention_fwd at :72).  Same
// function as the port's kernels/ref.py::attention_ref:
//
//   out[b, h] = softmax(mask(q[b, h] k[b, h / group]^T / sqrt(D))) v[b, h / group]
//
// with q [B, Hq, Sq, D], k [B, Hkv, Skv, D], v [B, Hkv, Skv, Dv] (Dv may
// differ from D: MLA scores over 192 columns and averages 128), group =
// Hq / Hkv (GQA and MQA through the kv-head map, no broadcast of k or v),
// a causal mask (qpos >= kpos), a sliding window (qpos - kpos < window)
// and a prefix-LM length P (the reference's make_mask_fn: keys below P
// are visible to every row, so rows below P see exactly [0, P) and rows at
// or past it [0, P) and their causal window), each optional.  Sq and Skv
// differ only without the causal mask (cross-attention: whisper's decoder
// rows over its encoder's frames).  float32 accumulation; output [B, Hq,
// Sq, Dv] in q's type.
//
// Bound: at the serving path's prefill shape (B 4, H 32, S 1024, D 64,
// bf16, causal) the inputs and the output are 67 MB, 20 us at 3.35 TB/s,
// and the causal half of the two products is 17 GFLOP, 17 us on the
// tensor cores: the two are close, so the products must run on the
// tensor cores and the loads must overlap them.
//
// Two kernels, chosen by the input type in flash_attention_launch:
//
// bfloat16: tensor cores fed by TMA (flash_attention_tc).  A persistent
// kernel, one block an SM, each taking work items (b, q head, 128-row q
// tile) in order of decreasing causal sweep; 384 threads in three
// warpgroups:
//   * warpgroup 0 is the producer: one thread issues TMA loads of the q
//     tiles (two buffers, so that the next item's q arrives during this
//     one's sweep, where they fit) and of kv tiles (128 keys while D and
//     Dv fit 2 column panels, 64 at 3, 32 at 4) into a ring of up to 4
//     stages, each with
//     a "full" mbarrier (the TMA's bytes) and an "empty" one (the
//     consumers' 8 warps); it gives registers away (setmaxnreg 40/232);
//   * warpgroups 1 and 2 are consumers of 64 q rows each: s = q k^T with
//     wgmma (q and k both K-major, 128-byte swizzled, D padded to NP column
//     panels of 64 by the TMA's zero fill; v in its own NPV panels of Dv,
//     NPV = NP or NP - 1),
//     the online softmax on the
//     accumulator's own layout (row max and sum within each quad of
//     lanes, running (max, sum) per row in registers, in log2 units), p
//     rounded to bf16 in registers as the A operand of o += p v (v
//     MN-major from shared memory, the transposed-B form), o in float32
//     registers, divided by max(sum, 1e-30) and stored as bf16 at the end;
//   * each consumer issues a tile's q k^T beside the last tile's p v and
//     runs its softmax while p v is on the tensor cores, and the two
//     consumers take turns to issue (named barriers), so that one's
//     softmax overlaps the other's products.
// Masks as the TPU kernel: -1e30 where the causal or window mask hides a
// key past the prefix, -inf past the end of Skv; only tiles an edge
// crosses are masked (a tile wholly inside the prefix is not).  kv tiles
// hidden from the whole q tile are not loaded, and tiles hidden from one
// consumer's 64 rows are not computed; with a prefix a row sweeps from key
// 0 (to max(row, P - 1) when causal), so a window's lower bound is then
// applied by the mask alone.  The one numeric change from
// the float32 arithmetic of the plain version is p's rounding to bf16.
// By count, the softmax's exponentials (one a score, on the special-
// function unit: 16,384 a 128 x 128 tile, 1,024 cycles at 16 a cycle)
// take as long as the tile's products at the tensor cores' peak at D 64;
// measured, the kernel runs at about a quarter of that peak (PERF.md).
//
// float32: SIMT (flash_attention_simt).  No rounding of float32 inputs to
// bf16 or TF32 keeps the float32 tolerance (2e-5), so the products stay
// on the float32 cores from shared memory.  One block per (b, q head,
// 64-row q tile) sweeps its kv tiles in a loop, carrying the running
// (max, denominator, accumulator) in registers:
//   * the q tile (scaled by 1/sqrt(D) in float32, as the TPU kernel
//     scales it) and each 64-row k and v tile are staged in shared
//     memory, k and q with a row stride of D + 1 so that lanes reading
//     different rows hit different banks;
//   * scores: each thread computes a 4 x 4 block of the 64 x 64 tile
//     (rows tr + 16a, keys tj + 16b), then masks it as above;
//   * softmax: warp w owns q rows 8w .. 8w + 7: it reduces each row's
//     maximum with shuffles, turns the scores into weights in place and
//     keeps each row's (max, denominator) in registers;
//   * p v: the same warp adds its rows' weights times v into a float32
//     accumulator, lane l holding columns l, l + 32, ... of Dv (NC of
//     them);
//   * at the end each row is divided by max(denominator, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using attn::kMasked;
using attn::kThreads;

constexpr int kBQ = 64;    // q rows of a block
constexpr int kBKV = 64;   // keys of a kv tile
constexpr int kRows = kBQ / attn::kWarps;  // q rows of a warp (8)
constexpr int kLdP = kBKV + 1;             // row stride of the score tile

size_t smem_bytes(int d, int dv) {
  const size_t ld = d + 1;
  return sizeof(float) * (kBQ * ld + kBKV * ld + kBKV * dv + kBQ * kLdP);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int s_q, int s_kv, int d, int dv, int causal,
                       int window, int prefix, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;              // [kBQ][ld], scaled
  float* ks = qs + kBQ * ld;     // [kBKV][ld]
  float* vs = ks + kBKV * ld;    // [kBKV][dv]
  float* ps = vs + kBKV * dv;    // [kBQ][kLdP]: scores, then weights

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest sweeps first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const long long bh = static_cast<long long>(b) * hq + h;
  const long long bk = static_cast<long long>(b) * hkv + hk;
  const long long q_off = bh * s_q * d, k_off = bk * s_kv * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  attn::load_tiles<T>(q + q_off, nullptr, q0, kBQ, s_q, d, scale, qs, ld,
                      nullptr, 0);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that some row of this q tile can see (the prefix's keys
  // are seen by every row)
  const int q_last = min(q0 + kBQ, s_q) - 1;
  int kt_hi = (s_kv + kBKV - 1) / kBKV;
  if (causal) kt_hi = min(kt_hi, max(q_last, prefix - 1) / kBKV + 1);
  const int kt_lo =
      window > 0 && prefix <= 0 ? max(0, q0 - window + 1) / kBKV : 0;

  const int tr = tid / 16, tj = tid % 16;  // score block of this thread
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // the last tile's readers are done
    if (dv == d) {
      attn::load_tiles<T>(k + k_off, v + k_off, k0, kBKV, s_kv, d, 1.f, ks,
                          ld, vs, d);
    } else {
      attn::load_tiles<T>(k + k_off, nullptr, k0, kBKV, s_kv, d, 1.f, ks,
                          ld, nullptr, 0);
      attn::load_tiles<T>(v + bk * s_kv * dv, nullptr, k0, kBKV, s_kv, dv,
                          1.f, vs, dv, nullptr, 0);
    }
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
        if (kpos >= s_kv) {
          x = -INFINITY;
        } else if (kpos >= prefix && ((causal && qpos < kpos) ||
                                      (window > 0 && qpos - kpos >= window))) {
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
        vv[c] = col < dv ? vs[j * dv + col] : 0.f;
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
    if (qpos >= s_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* out = o + (bh * s_q + qpos) * dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) attn::store(out + col, acc[i][c] * inv);
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o,
              int batch, int hq, int hkv, int s_q, int s_kv, int d, int dv,
              int causal, int window, int prefix, float scale,
              cudaStream_t stream) {
  auto kernel = flash_attention_simt<T, NC>;
  const size_t smem = smem_bytes(d, dv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_q + kBQ - 1) / kBQ, hq, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s_q, s_kv, d,
      dv, causal, window, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* q, const void* k, const void* v, void* o,
                int batch, int hq, int hkv, int s_q, int s_kv, int d, int dv,
                int causal, int window, int prefix, float scale,
                cudaStream_t stream) {
#define FLASH_NC(NC)                                                       \
  case NC:                                                                 \
    return launch_nc<T, NC>(q, k, v, o, batch, hq, hkv, s_q, s_kv, d, dv, \
                            causal, window, prefix, scale, stream);
  switch ((dv + 31) / 32) {
    FLASH_NC(1) FLASH_NC(2) FLASH_NC(3) FLASH_NC(4)
    FLASH_NC(5) FLASH_NC(6) FLASH_NC(7) FLASH_NC(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_NC
}

// ---- bfloat16: tensor cores fed by TMA ------------------------------------

namespace tc {

using hopper::desc_sw128;

constexpr int kPanel = 64;      // columns of a 128-byte swizzled panel
constexpr int kMaxStages = 4;
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// Keys of a kv tile, from the wider of D's and Dv's panel counts: 128
// while both fit two panels, then 64, and 32 at 4 panels, where the
// accumulators of 4 v panels take 128 of a consumer's 232 registers.
constexpr int kv_tile(int np, int npv) {
  return (np > npv ? np : npv) <= 2 ? 128 : (np > npv ? np : npv) == 3 ? 64
                                                                       : 32;
}

constexpr int kNC = 2;           // consumer warpgroups, 64 q rows each
constexpr int kBQ = 64 * kNC;    // q rows of a work item
constexpr int kThreads = 128 * (kNC + 1);
constexpr uint32_t kQPanelBytes = kBQ * 128;  // one q column panel

size_t smem_bytes(int np, int npv, int st, int nq) {
  return 1024 + nq * np * kQPanelBytes +
         1ull * st * (np + npv) * kv_tile(np, npv) * 128 + 8 * (2 * st + 4);
}

// Ring stages of k and v tiles (as many as fit, up to 4), then q buffers
// (two where they fit, so that the next item's q tile loads during a
// sweep).
void buffers(int np, int npv, int* nq, int* st) {
  for (*st = kMaxStages; *st >= 2; --*st)
    for (*nq = 2; *nq >= 1; --*nq)
      if (smem_bytes(np, npv, *st, *nq) <= kSmemLimit) return;
  *nq = 1;
  *st = 1;
}

// Scales a raw score tile where an edge crosses it to log2 units and
// masks it: -1e30 where the causal or window mask hides a key past the
// prefix, -inf at or past Skv (this thread's two rows).  Key 8 j + e of
// the tile is compared with per-thread limits, so each score costs three
// compares and two selects.  (Off the edges the scale rides in the
// exponent's FMA; here it is applied first, so that a masked score minus
// the row maximum is exact and weighs exactly 0 or 1, never an FMA
// residual of 1e30.)
template <int N>
__device__ __forceinline__ void mask_edge(float (&s)[N], int k0, int row_a,
                                          int col_l, int s_kv, int causal,
                                          int window, int prefix,
                                          float scale_log2) {
  const int base = k0 + col_l;  // key of j = e = 0
  const int end = s_kv - base;
  const int seen = prefix - base;  // keys x < seen are in the prefix
  // key x is hidden from row r when x > r - base (causal) or
  // x <= r - base - window (window)
  const int hi_a = causal ? row_a - base : INT_MAX;
  const int hi_b = causal ? row_a + 8 - base : INT_MAX;
  const int lo_a = window > 0 ? row_a - base - window : INT_MIN;
  const int lo_b = window > 0 ? row_a + 8 - base - window : INT_MIN;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = 8 * j + e;
      float& a = s[4 * j + e];
      float& b = s[4 * j + 2 + e];
      a = (x >= seen && (x > hi_a || x <= lo_a)) ? kMasked : a * scale_log2;
      b = (x >= seen && (x > hi_b || x <= lo_b)) ? kMasked : b * scale_log2;
      if (x >= end) a = b = -INFINITY;
    }
  }
}

// One work item: a (b, q head, q tile) and the kv tiles it sees.
struct Item {
  int q0, h, b, kt_lo, n_tiles;
};

// Work item w: q tiles in order of decreasing sweep length (the longest
// causal sweeps first), heads fastest, so that neighbours share k and v.
template <int BKV>
__device__ __forceinline__ Item work_item(int w, int n_qt, int hq, int batch,
                                          int s_q, int s_kv, int causal,
                                          int window, int prefix) {
  Item r;
  const int hb = hq * batch, rem = w % hb;
  r.q0 = (n_qt - 1 - w / hb) * kBQ;
  r.h = rem % hq;
  r.b = rem / hq;
  const int q_last = min(r.q0 + kBQ, s_q) - 1;
  int kt_hi = (s_kv + BKV - 1) / BKV;
  if (causal) kt_hi = min(kt_hi, max(q_last, prefix - 1) / BKV + 1);
  r.kt_lo = window > 0 && prefix <= 0 ? max(0, r.q0 - window + 1) / BKV : 0;
  r.n_tiles = kt_hi - r.kt_lo;
  return r;
}

// NP: column panels of 64 that hold D (D padded with zeros to 64 NP);
// NPV: those that hold Dv; BKV: keys of a kv tile.  A persistent kernel:
// block i takes work items i, i + grid, ...; the k/v ring runs on across
// items, and with two q buffers (nq) the next item's q tile loads during
// this one's sweep.
template <int NP, int NPV, int BKV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, int batch, int hq, int hkv,
                   int s_q, int s_kv, int dv, int causal, int window,
                   int prefix, float scale_log2, int st, int nq) {
  constexpr uint32_t kKVPanelBytes = BKV * 128;  // one k or v column panel
  constexpr uint32_t kQBytes = NP * kQPanelBytes;
  constexpr int kS = BKV / 2;                    // score registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + nq * kQBytes;           // [st][NP] panels of BKV keys
  uint8_t* vs = ks + st * NP * kKVPanelBytes;  // [st][NPV] panels
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + st * NPV * kKVPanelBytes);
  uint64_t* empty = full + st;
  uint64_t* q_full = empty + st;
  uint64_t* q_empty = q_full + 2;

  const int n_qt = (s_q + kBQ - 1) / kBQ;
  const int n_items = n_qt * hq * batch;

  if (threadIdx.x == 0) {
    for (int i = 0; i < st; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 4 * kNC);  // the consumers' warps
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(q_full + i, 1);
      hopper::mbar_init(q_empty + i, 4 * kNC);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load ----
    hopper::setmaxnreg_dec<40>();  // 128 x 40 + 256 x 232 = 384 x 168
    if (threadIdx.x == 0) {
      int t = 0;  // kv tiles issued so far
      for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
        const Item item = work_item<BKV>(w, n_qt, hq, batch, s_q, s_kv,
                                         causal, window, prefix);
        const int bq = item.b * hq + item.h;
        const int bk = item.b * hkv + item.h / (hq / hkv);
        const int qb = j % nq;
        if (j >= nq) hopper::mbar_wait(q_empty + qb, (j / nq - 1) & 1);
        hopper::mbar_expect_tx(q_full + qb, kQBytes);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          hopper::tma_load_3d(qs + qb * kQBytes + p * kQPanelBytes, &map_q,
                              q_full + qb, p * kPanel, item.q0, bq);
        for (int i = 0; i < item.n_tiles; ++i, ++t) {
          const int stage = t % st;
          if (t >= st) hopper::mbar_wait(empty + stage, (t / st - 1) & 1);
          const int k0 = (item.kt_lo + i) * BKV;
          hopper::mbar_expect_tx(full + stage, (NP + NPV) * kKVPanelBytes);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            hopper::tma_load_3d(ks + (stage * NP + p) * kKVPanelBytes,
                                &map_k, full + stage, p * kPanel, k0, bk);
#pragma unroll
          for (int p = 0; p < NPV; ++p)
            hopper::tma_load_3d(vs + (stage * NPV + p) * kKVPanelBytes,
                                &map_v, full + stage, p * kPanel, k0, bk);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    hopper::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int col_l = 2 * (lane % 4);
    float acc[NPV][32];
    float s[kS];
    uint32_t pa[BKV / 16][4];  // p in bf16: the A fragments of p v
    // Ring position of the current kv tile, advanced one tile at a time
    // across all items.
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&] {
      if (++stage == st) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto pass = [&] {  // a tile hidden from all 64 rows
      hopper::mbar_wait(full + stage, phase);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + stage);
    };

    for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
      const Item item = work_item<BKV>(w, n_qt, hq, batch, s_q, s_kv,
                                       causal, window, prefix);
      const int q0 = item.q0, kt_lo = item.kt_lo, n_tiles = item.n_tiles;
      const int qr0 = q0 + 64 * c;  // first q row of this consumer
      // accumulator rows of this thread (wgmma's D layout)
      const int row_a = qr0 + 16 * warp + lane / 4, row_b = row_a + 8;
      const int qb = j % nq;
      const uint32_t q_addr =
          hopper::smem_addr(qs + qb * kQBytes) + 64 * 128 * c;

      // Visible tiles [x, y) of consumer cc's sweep; a consumer still
      // takes every tile's "full" phase and gives its "empty" one.
      auto span = [&](int cc) {
        const int r0 = q0 + 64 * cc;
        int lo = 0, hi = n_tiles;
        if (r0 >= s_q) {
          hi = 0;
        } else {
          if (causal) hi = min(hi, max(r0 + 63, prefix - 1) / BKV + 1 - kt_lo);
          if (window > 0 && prefix <= 0)
            lo = max(0, r0 - window + 1) / BKV - kt_lo;
        }
        return make_int2(lo, hi);
      };
      const int2 mine = span(c);
      const int it_lo = mine.x, it_hi = mine.y;
      // Turns: the consumers issue their wgmma batches (one a tile, plus
      // one to close) in rounds, consumer 0 first, so that one's softmax
      // runs while another's products are on the tensor cores.  Batch k
      // of consumer c waits on named barrier bar0 + c for its predecessor
      // (the last consumer before c with a batch k, else the last with a
      // batch k - 1) and signals its successor the same way round.  Odd
      // and even items take separate barriers: a consumer that has moved
      // on to the next item must not complete a barrier phase of one
      // still in this item, and none can be two items ahead (the next q
      // tile but one loads only when all have read this one).
      const int bar0 = 1 + kNC * (j & 1);
      int n_batches[kNC];
#pragma unroll
      for (int cc = 0; cc < kNC; ++cc) {
        const int2 sp = span(cc);
        n_batches[cc] = sp.y > sp.x ? sp.y - sp.x + 1 : 0;
      }
      int batch_no = 0;
      auto turn_begin = [&] {
        bool wait = batch_no > 0;  // batch k - 1 of its own comes before
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc)
          wait |= cc < c && batch_no < n_batches[cc];
        if (wait) hopper::named_bar_sync(bar0 + c, 256);
      };
      auto turn_end = [&] {
        int next = -1;
#pragma unroll
        for (int cc = kNC - 1; cc > c; --cc)
          if (batch_no < n_batches[cc]) next = cc;
        if (next < 0) {
#pragma unroll
          for (int cc = kNC - 1; cc >= 0; --cc)
            if (batch_no + 1 < n_batches[cc]) next = cc;
        }
        if (next >= 0) hopper::named_bar_arrive(bar0 + next, 256);
        ++batch_no;
      };
      auto scores = [&] {  // issue s = q k^T
        const uint32_t k_addr =
            hopper::smem_addr(ks + stage * NP * kKVPanelBytes);
#pragma unroll
        for (int kk = 0; kk < 4 * NP; ++kk) {
          const uint32_t panel = kk / 4, col = (kk % 4) * 32;
          hopper::wgmma_scores(
              s, desc_sw128(q_addr + panel * kQPanelBytes + col, 16, 1024),
              desc_sw128(k_addr + panel * kKVPanelBytes + col, 16, 1024),
              kk > 0);
        }
      };
      auto pv = [&](int at) {  // issue o += p v from ring stage `at`
        const uint32_t v_addr =
            hopper::smem_addr(vs + at * NPV * kKVPanelBytes);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NPV; ++p)
            hopper::wgmma_m64n64k16_rs_tb(
                acc[p], pa[kk],
                desc_sw128(v_addr + p * kKVPanelBytes + kk * 16 * 128,
                           kKVPanelBytes, 1024));
      };
      float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
      // Turns the raw scores of tile it (in s) into weights against the
      // new running maxima (log2 units: the scale folds into the
      // exponent's FMA off the edges); returns the factors that rescale
      // the old state.
      auto softmax = [&](int it) {
        const int k0 = (kt_lo + it) * BKV;
        float c_log2 = scale_log2;  // what turns s into log2 units
        if (k0 + BKV > s_kv ||
            (k0 + BKV > prefix && ((causal && k0 + BKV - 1 > qr0) ||
                                   (window > 0 && qr0 + 63 - k0 >= window)))) {
          mask_edge(s, k0, row_a, col_l, s_kv, causal, window, prefix,
                    scale_log2);
          c_log2 = 1.f;
        }
        float mx_a = s[0], mx_b = s[2];
#pragma unroll
        for (int i = 0; i < kS / 4; ++i) {
          mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
          mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(attn::kFull, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(attn::kFull, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a * c_log2);
        const float mn_b = fmaxf(m_b, mx_b * c_log2);
        const float2 alpha = make_float2(hopper::exp2_approx(m_a - mn_a),
                                         hopper::exp2_approx(m_b - mn_b));
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < kS / 4; ++i) {
          s[4 * i] = hopper::exp2_approx(fmaf(s[4 * i], c_log2, -m_a));
          s[4 * i + 1] =
              hopper::exp2_approx(fmaf(s[4 * i + 1], c_log2, -m_a));
          s[4 * i + 2] =
              hopper::exp2_approx(fmaf(s[4 * i + 2], c_log2, -m_b));
          s[4 * i + 3] =
              hopper::exp2_approx(fmaf(s[4 * i + 3], c_log2, -m_b));
          sum_a += s[4 * i] + s[4 * i + 1];
          sum_b += s[4 * i + 2] + s[4 * i + 3];
        }
        l_a = l_a * alpha.x + sum_a;
        l_b = l_b * alpha.y + sum_b;
        return alpha;
      };
      auto rescale_and_pack = [&](float2 alpha) {
#pragma unroll
        for (int p = 0; p < NPV; ++p)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[p][4 * i] *= alpha.x;
            acc[p][4 * i + 1] *= alpha.x;
            acc[p][4 * i + 2] *= alpha.y;
            acc[p][4 * i + 3] *= alpha.y;
          }
#pragma unroll
        for (int i = 0; i < kS / 4; ++i) {
          const __nv_bfloat162 ha =
              __floats2bfloat162_rn(s[4 * i], s[4 * i + 1]);
          const __nv_bfloat162 hb =
              __floats2bfloat162_rn(s[4 * i + 2], s[4 * i + 3]);
          pa[i / 2][(i % 2) * 2] = *reinterpret_cast<const uint32_t*>(&ha);
          pa[i / 2][(i % 2) * 2 + 1] =
              *reinterpret_cast<const uint32_t*>(&hb);
        }
      };

#pragma unroll
      for (int p = 0; p < NPV; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
      hopper::mbar_wait(q_full + qb, (j / nq) & 1);
      int it = 0;
      for (; it < min(it_lo, n_tiles); ++it, advance()) pass();
      if (it < it_hi) {
        // The first tile alone, then each tile's scores issued beside the
        // last tile's p v, its softmax running while p v is on the tensor
        // cores.
        hopper::mbar_wait(full + stage, phase);
        turn_begin();
        hopper::wgmma_fence();
        scores();
        hopper::wgmma_commit();
        turn_end();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(s);
        rescale_and_pack(softmax(it));
        int last = stage;
        for (++it, advance(); it < it_hi; ++it, advance()) {
          hopper::mbar_wait(full + stage, phase);
          turn_begin();
          hopper::wgmma_fence();
          scores();
          hopper::wgmma_commit();
          pv(last);
          hopper::wgmma_commit();
          turn_end();
          hopper::wgmma_wait<1>();  // the scores are in
          hopper::fence_operands(s);
          const float2 alpha = softmax(it);
          hopper::wgmma_wait<0>();  // p v of the last tile is done
#pragma unroll
          for (int p = 0; p < NPV; ++p) hopper::fence_operands(acc[p]);
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(empty + last);
          rescale_and_pack(alpha);
          last = stage;
        }
        turn_begin();
        hopper::wgmma_fence();
        pv(last);
        hopper::wgmma_commit();
        turn_end();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NPV; ++p) hopper::fence_operands(acc[p]);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + last);
      }
      for (; it < n_tiles; ++it, advance()) pass();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(q_empty + qb);  // q tile read

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(attn::kFull, l_a, off);
        l_b += __shfl_xor_sync(attn::kFull, l_b, off);
      }
      const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
      const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
      __nv_bfloat16* ob =
          o + (static_cast<long long>(item.b) * hq + item.h) * s_q * dv;
#pragma unroll
      for (int p = 0; p < NPV; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = p * kPanel + 8 * i + col_l;
          if (col >= dv) continue;
          if (row_a < s_q)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + static_cast<long long>(row_a) * dv + col) =
                __floats2bfloat162_rn(acc[p][4 * i] * inv_a,
                                      acc[p][4 * i + 1] * inv_a);
          if (row_b < s_q)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + static_cast<long long>(row_b) * dv + col) =
                __floats2bfloat162_rn(acc[p][4 * i + 2] * inv_b,
                                      acc[p][4 * i + 3] * inv_b);
        }
    }
  }
}

template <int NP, int NPV>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              int batch, int hq, int hkv, int s_q, int s_kv, int d, int dv,
              int causal, int window, int prefix, float scale,
              cudaStream_t stream) {
  constexpr int kBKV = kv_tile(NP, NPV);
  CUtensorMap map_q, map_k, map_v;
  int err = hopper::make_map_bf16(&map_q, q, batch * hq, s_q, d, kBQ);
  if (!err) err = hopper::make_map_bf16(&map_k, k, batch * hkv, s_kv, d,
                                        kBKV);
  if (!err) err = hopper::make_map_bf16(&map_v, v, batch * hkv, s_kv, dv,
                                        kBKV);
  if (err) return err;
  int nq, st;
  buffers(NP, NPV, &nq, &st);
  const size_t smem = smem_bytes(NP, NPV, st, nq);
  auto kernel = flash_attention_tc<NP, NPV, kBKV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items =
      static_cast<long long>((s_q + kBQ - 1) / kBQ) * hq * batch;
  if (items > (1ll << 31) - 1) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(items, sms));
  kernel<<<grid, kThreads, smem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), batch, hq, hkv,
      s_q, s_kv, dv, causal, window, prefix, scale * kLog2e, st, nq);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation for each panel count of D (1 to 4) with Dv's equal
// to it or one fewer (MLA: D 192, Dv 128); other pairs return
// cudaErrorInvalidValue (ops.flash_attention refuses them first).  Add a
// pair when a config needs it.
template <int NP>
int launch_np(const void* q, const void* k, const void* v, void* o,
              int batch, int hq, int hkv, int s_q, int s_kv, int d, int dv,
              int causal, int window, int prefix, float scale,
              cudaStream_t stream) {
  const int npv = (dv + kPanel - 1) / kPanel;
  if (npv == NP)
    return launch_tc<NP, NP>(q, k, v, o, batch, hq, hkv, s_q, s_kv, d, dv,
                             causal, window, prefix, scale, stream);
  if constexpr (NP > 1) {
    if (npv == NP - 1)
      return launch_tc<NP, NP - 1>(q, k, v, o, batch, hq, hkv, s_q, s_kv, d,
                                   dv, causal, window, prefix, scale, stream);
  }
  return cudaErrorInvalidValue;
}

int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int s_q, int s_kv, int d, int dv, int causal,
           int window, int prefix, float scale, cudaStream_t stream) {
#define FLASH_NP(NP)                                                        \
  case NP:                                                                  \
    return launch_np<NP>(q, k, v, o, batch, hq, hkv, s_q, s_kv, d, dv,     \
                         causal, window, prefix, scale, stream);
  switch ((d + kPanel - 1) / kPanel) {
    FLASH_NP(1) FLASH_NP(2) FLASH_NP(3) FLASH_NP(4)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_NP
}

}  // namespace tc

}  // namespace

// q [batch, hq, s_q, d], k [batch, hkv, s_kv, d], v [batch, hkv, s_kv,
// dv], o [batch, hq, s_q, dv]: all contiguous, 16-byte aligned, of one
// type (bf16 != 0: bfloat16, run on the tensor cores; else float32, run
// on the SIMT kernel).  d and dv are multiples of 8 in [8, 256], hq a
// multiple of hkv; s_q == s_kv when causal; window <= 0 means no window
// and prefix <= 0 no prefix.  scale is 1/sqrt(d) in float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int hq, int hkv, int s_q, int s_kv,
                                      int d, int dv, int causal, int window,
                                      int prefix, float scale, int bf16,
                                      void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || s_q < 1 || s_kv < 1 ||
      (causal && s_q != s_kv) || d < 8 || d > 256 || d % 8 || dv < 8 ||
      dv > 256 || dv % 8 || hq > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)  // the tensor-core kernel
    return tc::launch(q, k, v, o, batch, hq, hkv, s_q, s_kv, d, dv, causal,
                      window, prefix, scale, st);
  return launch_type<float>(q, k, v, o, batch, hq, hkv, s_q, s_kv, d, dv,
                            causal, window, prefix, scale, st);
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
