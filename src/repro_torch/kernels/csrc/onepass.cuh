// One-launch building blocks of the redesigned replay kernels
// (rank_select.cu, multi_query_match.cu and amper_sample.cu).
//
// Tiles.  A block of T threads takes a tile of 4 T L rows: thread t's
// load l covers rows tile0 + 4 T l + 4 t .. +3, one int4 of pq and one
// uchar4 of valid, so each load is coalesced across the block and a
// thread has its 2 L loads in flight before its first compare.  A tile
// wholly inside the table is read with vector loads only; the ragged last
// tile goes through common.cuh's load4.  A tile's membership can be kept
// in shared memory as 32-bit words in index order, with each word's
// exclusive member prefix in the tile (store_words, word_prefixes), from
// which the member of any tile-local rank is found without reading the
// tile again (resolve).
//
// Cross-block state without a memset.  The kernels keep their
// cross-block words (look-back status words, tickets, partial counts) in
// a scratch buffer that the wrapper allocates zeroed once per device and
// stream and reuses; how each keeps a call from seeing the last one's
// words is in its source and below.
//
// The range test on the FP32 pipe.  With A the smallest lo and B the
// largest hi of the non-empty ranges and B - A < 2^24, a row's key
//   x = valid ? clamp(p, A - 1, B + 1) - A : -1
// and a range's L = 1 - (lo - A), H = hi - A + 1 are integers that float32
// holds exactly, and
//   sat(x + L) * sat(H - x) = (lo <= p <= hi) ? 1 : 0
// where sat clamps to [0, 1] (x + L >= 1 when p >= lo, <= 0 when not;
// likewise H - x).  So a test is two saturating adds and one FMA that
// accumulates it: three instructions of the FP32 pipe, where the integer
// form (two compares, an and, an add or an or) runs on the half-rate
// integer pipe.  An empty range (lo > hi) gets L = H = -inf and never
// holds; a row clamped to A - 1 or B + 1 lies outside every range, as the
// row itself does, and an invalid row's key -1 lies below every range.
// Ranges that no 2^24 window holds, or no non-empty range at all, take
// the integer test (`fp` false).
//
// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016).  Tile t publishes one 64-bit
// status word, flag in bits 32-33 and a member count in bits 0-31 (a
// count is below 2^31, since n is): first (aggregate, its own count), and
// once it knows its exclusive prefix, (inclusive, prefix + count), each
// word tagged with the call's epoch.  A tile waits only on lower tiles,
// so the spin ends as long as every lower tile's block is running or
// done: rank_select takes tiles from an atomic ticket in launch order,
// amper_sample runs a cooperative grid whose blocks are all resident.
// Integer sums are exact, so the prefix does not depend on which words a
// tile happened to find.
//
// Epochs on the card.  The scratch holds the epoch of the last call that
// finished on it (0 when made), and a call runs at that epoch + 1, read
// by every block as it starts.  Each block adds one to a done counter
// once it will read no status word again (one atomic, whose old value
// the block reads only after its own work); the block whose add
// completes the count finished the call last (finish_call): it resets
// the counter (and rank_select's ticket), and sets the next call's
// epoch.  After epoch 2^30 - 1 it zeroes every status word of the
// scratch first and the epochs start again at 1, so no two calls that
// share a word share an epoch.  A call queued behind this one on the
// stream starts only after it has ended, and a CUDA graph's replays
// advance the same words, so the host counts nothing and a captured call
// replays correctly.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace onepass {

using amper::kFull;

// The 4 L rows of one thread in a tile: pq as L int4, and valid as L
// words of 4 flag bytes (what the loads bring, kept packed while a tile
// waits in registers).
template <int L>
struct Rows {
  int4 p[L];
  unsigned v[L];
};

// Loads the rows of thread threadIdx.x in the tile starting at row tile0
// (a block of T threads); rows at or past n read as invalid.
template <int T, int L>
__device__ __forceinline__ Rows<L> load_rows(const int32_t* __restrict__ pq,
                                             const uint8_t* __restrict__ valid,
                                             long long n, long long tile0) {
  Rows<L> r;
  const long long row0 = tile0 + 4 * threadIdx.x;
  if (tile0 + 4LL * T * L <= n) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      r.p[l] = *reinterpret_cast<const int4*>(pq + row0 + 4LL * T * l);
      r.v[l] = *reinterpret_cast<const unsigned*>(valid + row0 + 4LL * T * l);
    }
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      int32_t p[4];
      bool v[4];
      amper::load4(pq, valid, n, row0 + 4LL * T * l, p, v);
      r.p[l] = make_int4(p[0], p[1], p[2], p[3]);
      r.v[l] = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
    }
  }
  return r;
}

// Row k of the thread (0 <= k < 4 L): its pq and valid.
template <int L>
__device__ __forceinline__ void unpack(const Rows<L>& r, int32_t (&p)[4 * L],
                                       bool (&v)[4 * L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    p[4 * l + 0] = r.p[l].x;
    p[4 * l + 1] = r.p[l].y;
    p[4 * l + 2] = r.p[l].z;
    p[4 * l + 3] = r.p[l].w;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * l + k] = (r.v[l] >> (8 * k)) & 0xffu;
  }
}

// The float form of the range test (see the header).
struct Window {
  int a, b;  // A and B
  bool fp;   // the float test is exact
};

// The m ranges as lane l of one warp holds them: ranges l and l + 32
// (empty, lo > hi, past m).
struct LaneRanges {
  int lo[2], hi[2];
};

__device__ __forceinline__ LaneRanges load_lane_ranges(
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi, int m) {
  const int lane = threadIdx.x & 31;
  LaneRanges r;
#pragma unroll
  for (int q = 0; q < 2; ++q) {  // m <= 64
    const int i = lane + 32 * q;
    r.lo[q] = i < m ? lo[i] : 1;
    r.hi[q] = i < m ? hi[i] : 0;
  }
  return r;
}

// Called by the 32 lanes of one warp with the ranges of load_lane_ranges:
// copies the m ranges to shared memory (s_lo, s_hi), with their float
// form (s_l, s_h), and returns the window in every lane.
__device__ __forceinline__ Window prepare_ranges(LaneRanges r, int m,
                                                 int32_t* s_lo, int32_t* s_hi,
                                                 float* s_l, float* s_h) {
  const int lane = threadIdx.x & 31;
  int a = 0x7fffffff, b = -0x7fffffff - 1;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (r.lo[q] <= r.hi[q]) {
      a = min(a, r.lo[q]);
      b = max(b, r.hi[q]);
    }
  }
  a = __reduce_min_sync(kFull, a);
  b = __reduce_max_sync(kFull, b);
  const Window win{a, b, a <= b && static_cast<long long>(b) - a < (1 << 24)};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int i = lane + 32 * q;
    if (i >= m) continue;
    s_lo[i] = r.lo[q];
    s_hi[i] = r.hi[q];
    const bool live = win.fp && r.lo[q] <= r.hi[q];
    s_l[i] = live ? static_cast<float>(1 - (r.lo[q] - a)) : -INFINITY;
    s_h[i] = live ? static_cast<float>(r.hi[q] - a + 1) : -INFINITY;
  }
  return win;
}

// A row's key x (see above); only for a window with fp set.
__device__ __forceinline__ float row_key(int32_t p, bool v, Window w) {
  const int c = p < w.a ? w.a - 1 : p > w.b ? w.b + 1 : p;
  return v ? static_cast<float>(c - w.a) : -1.0f;
}

__device__ __forceinline__ float sat_add(float x, float y) {
  float r;
  asm("add.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float sat_sub(float x, float y) {
  float r;
  asm("sub.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// acc + (row key x in the range (l, h) ? 1 : 0)
__device__ __forceinline__ float add_hit(float x, float l, float h,
                                         float acc) {
  return fmaf(sat_add(x, l), sat_sub(h, x), acc);
}

// Status words: a member count in bits 0-31, the flag in bits 32-33 (1
// aggregate, 2 inclusive) and the call's epoch in bits 34-63.  A word of
// another epoch reads as not yet published.  Tile t's word is at
// status[t * kStatusStride]: one word a 128-byte line, so that the
// blocks polling their predecessors spread over the L2's slices instead
// of crowding a few lines.
constexpr unsigned kAggregate = 1, kInclusive = 2;
constexpr int kStatusStride = 16;

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          unsigned flag,
                                                          int value) {
  return (static_cast<unsigned long long>(epoch) << 34) |
         (static_cast<unsigned long long>(flag) << 32) |
         static_cast<unsigned>(value);
}

// The flag of w in this epoch: 0 when not published yet.
__device__ __forceinline__ unsigned status_flag(unsigned long long w,
                                                unsigned epoch) {
  return (w >> 34) == epoch ? static_cast<unsigned>(w >> 32) & 3u : 0u;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* w) {
  unsigned long long x;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(x) : "l"(w));
  return x;
}

__device__ __forceinline__ void store_status(unsigned long long* w,
                                             unsigned long long x) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(w), "l"(x)
               : "memory");
}

// Called by all 32 lanes of one warp of tile t > 0, after the tile has
// published its aggregate: the members of tiles 0 .. t-1.  A round reads
// the 32 nearest words not yet read (lane l: tile end - l); the nearest
// inclusive word ends the walk, and every aggregate nearer than it adds
// in.  (Reading 64 or 128 words a round measured slower.)
__device__ __forceinline__ int lookback(const unsigned long long* status,
                                        int t, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int end = t - 1;; end -= 32) {
    const int pred = end - lane;
    unsigned long long w = status_word(epoch, kInclusive, 0);  // before 0
    if (pred >= 0)
      while (status_flag(w = load_status(status + pred * kStatusStride),
                         epoch) == 0) {
      }
    const unsigned inc =
        __ballot_sync(kFull, status_flag(w, epoch) == kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    excl += static_cast<int>(__reduce_add_sync(
        kFull, lane <= stop ? static_cast<unsigned>(w) : 0u));
    if (inc) return excl;
  }
}

// Position of the k-th (0-based) set bit of x, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned x, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w; w >>= 1) {
    const unsigned low = x & ((1u << w) - 1);
    const int c = __popc(low);
    if (k >= c) {
      k -= c;
      x >>= w;
      pos += w;
    } else {
      x = low;
    }
  }
  return pos;
}


// The tile's membership: mem[k] for the row of p[k], v[k].
template <int R>
__device__ __forceinline__ void test_rows(const int32_t (&p)[R],
                                          const bool (&v)[R], Window win,
                                          int m, const int32_t* s_lo,
                                          const int32_t* s_hi,
                                          const float* s_l, const float* s_h,
                                          bool (&mem)[R]) {
  if (win.fp) {
    float x[R], hits[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      x[k] = row_key(p[k], v[k], win);
      hits[k] = 0.0f;
    }
    for (int i = 0; i < m; ++i) {
      const float l = s_l[i], h = s_h[i];
#pragma unroll
      for (int k = 0; k < R; ++k) hits[k] = add_hit(x[k], l, h, hits[k]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) mem[k] = hits[k] > 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) mem[k] = false;
    for (int i = 0; i < m; ++i) {
      const int32_t a = s_lo[i], b = s_hi[i];
#pragma unroll
      for (int k = 0; k < R; ++k)
        mem[k] |= v[k] & (p[k] >= a) & (p[k] <= b);
    }
  }
}

// Called by every thread of a block of T threads with the membership of
// its 4 L rows in a tile: writes the tile's membership as 4 T L / 32
// words in index order.  Rows 4 tid .. 4 tid + 3 of load l are bits
// 4 (tid % 8) .. +3 of word (4 T l + 4 tid) / 32, ORed across 8 lanes by
// shuffles.
template <int T, int L>
__device__ __forceinline__ void store_words(const bool (&mem)[4 * L],
                                            unsigned* words) {
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    unsigned nib = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      nib |= static_cast<unsigned>(mem[4 * l + k]) << k;
    unsigned w = nib << (4 * (lane & 7));
    w |= __shfl_xor_sync(kFull, w, 1);
    w |= __shfl_xor_sync(kFull, w, 2);
    w |= __shfl_xor_sync(kFull, w, 4);
    if ((lane & 7) == 0) words[l * (T / 8) + (tid >> 3)] = w;
  }
}

// Called by the 32 lanes of one warp: pre[w] = the members of the tile's
// words 0 .. w-1; returns the tile's members in every lane.
template <int kWords>
__device__ __forceinline__ int word_prefixes(const unsigned* words,
                                             int* pre) {
  static_assert(kWords % 32 == 0, "a warp scans the tile's words");
  constexpr int kPerLane = kWords / 32;
  const int lane = threadIdx.x & 31;
  int c[kPerLane];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    c[k] = __popc(words[lane * kPerLane + k]);
    sum += c[k];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int run = incl - sum;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    pre[lane * kPerLane + k] = run;
    run += c[k];
  }
  return __shfl_sync(kFull, incl, 31);
}

// The tile-local offset of the lr-th member (0 <= lr < members).  The
// largest word whose prefix is <= lr holds it, since empty words never
// end a run of prefixes <= lr.
template <int kWords>
__device__ __forceinline__ int resolve(const unsigned* words, const int* pre,
                                       int lr) {
  int lo = 0, hi = kWords - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= lr) lo = mid; else hi = mid - 1;
  }
  return 32 * lo + nth_set_bit(words[lo], lr - pre[lo]);
}

// The epochs of the header: a call runs at *epoch_word + 1, in
// 1 .. kMaxEpoch.
constexpr unsigned kMaxEpoch = (1u << 30) - 1;

// The add of a block to the done counter, made once the block reads no
// status word again; the block waits for the old value only after its
// own work, or in a thread that has none.  It orders nothing, and needs
// not, except in the call at kMaxEpoch: there the last block zeroes the
// status words, so every block's status stores (made before a
// __syncthreads, or by the adding thread) must come before its add
// (release, cumulative) and the last block's zeroing after every add
// (acquire).
__device__ __forceinline__ unsigned arrive(unsigned* done, unsigned x,
                                           unsigned epoch) {
  unsigned old;
  if (epoch == kMaxEpoch)
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(done), "r"(x) : "memory");
  else
    asm volatile("atom.relaxed.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "l"(done), "r"(x) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long arrive(unsigned long long* done,
                                                     unsigned long long x,
                                                     unsigned epoch) {
  unsigned long long old;
  if (epoch == kMaxEpoch)
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
                 : "=l"(old) : "l"(done), "l"(x) : "memory");
  else
    asm volatile("atom.relaxed.gpu.global.add.u64 %0, [%1], %2;"
                 : "=l"(old) : "l"(done), "l"(x) : "memory");
  return old;
}

// Called by one thread of the block that finished the call at `epoch`
// last (no block reads a status word of this call again): sets the next
// call's epoch, after the last one zeroing the `words` status words of
// the scratch (every word a call of it may have written) so that the
// epochs can start again at 1.
__device__ __forceinline__ void finish_call(unsigned* epoch_word,
                                            unsigned epoch,
                                            unsigned long long* status,
                                            int words) {
  if (epoch == kMaxEpoch) {
    for (int t = 0; t < words; ++t) status[t * kStatusStride] = 0;
    *epoch_word = 0;
  } else {
    *epoch_word = epoch;
  }
}

}  // namespace onepass
