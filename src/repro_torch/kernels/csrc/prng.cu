// jax.random's key derivations and draws on keys that live on the card,
// for Hopper: split, fold_in, bits, uniform and randint, each call one
// launch.
//
// Not a port of a TPU kernel: the counterpart of the threefry that
// jax.random runs through XLA on the device.  Same functions as the
// port's kernels/prng.py plain versions (split_ref, fold_in_ref,
// bits_ref, uniform_ref, randint_ref) and as repro_torch/prng.py's numpy
// path, bit for bit, in jax's partitionable layout (threefry.cuh).  For
// B keys (int64 pairs holding uint32 words) and N positions a key, element
// e = b * N + j computes
//
//   kCipher   out[e] = threefry(key_b, (0, offset + j))   int64 [B, N, 2]
//             (split: offset 0, N = n; fold_in: offset = data, N = 1)
//   kBits     out[e] = o0 ^ o1 of threefry(key_b, (0, j))  int64 [B, N]
//   kUniform  f = bitcast((bits >> 9) | 0x3f800000) - 1;
//             out[e] = max(lo, fma(f, hi - lo, lo))        float32 [B, N]
//   kRandint  (k1, k2) = split(key_b); hb = bits(k1)[j], lb = bits(k2)[j];
//             span = hi <= lo ? 1 : (hi - lo) mod 2^32;
//             mult = (2^16 % span)^2 mod 2^32 % span;
//             out[e] = lo + ((hb % span) * mult + lb % span) % span
//                                                          int32 [B, N]
// in uint32 arithmetic that wraps.  The uniform's one fma is
// __fmaf_rn, the multiply-add XLA fuses the reference's expression into
// (xla_float.fma32 on the host); randint's bounds are int64 host values
// or int32 / int64 scalars read on the device, so a bound computed on the
// card needs no host sync.
//
// Bound: bytes.  Each output word is written once (8 B an element for a
// key word or a bits draw, 4 B for a uniform or randint) and each key
// read once: 8 MB for bits at N = 1e6, about 2.4 us at 3.35 TB/s.  The
// 20 rounds of the cipher (about 100 integer operations an element, 200
// for randint's two draws) stay below that on the integer pipes.  At the
// few words a training step asks for, the launch itself bounds a call.
//
// Design: one thread an element over a grid-stride loop, the key's words
// read through the read-only path; no shared memory, no scratch, nothing
// carried between blocks, so a call can be captured in a CUDA graph as
// it is.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // a few waves; the loop strides

enum Op { kCipher = 0, kBits = 1, kUniform = 2, kRandint = 3 };

struct Params {
  const long long* keys;  // B keys of two words, key_stride apart
  long long n_keys, key_stride, per_key;
  unsigned offset;
  int op;
  float lo_f, hi_f;
  long long lo_i, hi_i;       // when lo_ptr / hi_ptr are null
  const void* lo_ptr;         // int32 or int64 scalar on the device
  const void* hi_ptr;
  int lo_64, hi_64;           // 1: the pointer holds an int64
  void* out;
};

__device__ __forceinline__ long long read_bound(const void* p, int is64,
                                                long long host) {
  if (p == nullptr) return host;
  return is64 ? __ldg(static_cast<const long long*>(p))
              : static_cast<long long>(__ldg(static_cast<const int32_t*>(p)));
}

__global__ void __launch_bounds__(kThreads) prng_kernel(const Params P) {
  const long long total = P.n_keys * P.per_key;
  long long lo = 0, hi = 0;
  uint32_t span = 1, mult = 0;
  if (P.op == kRandint) {
    lo = read_bound(P.lo_ptr, P.lo_64, P.lo_i);
    hi = read_bound(P.hi_ptr, P.hi_64, P.hi_i);
    span = hi <= lo ? 1u : static_cast<uint32_t>(
                               static_cast<unsigned long long>(hi - lo));
    mult = 65536u % span;
    mult = (mult * mult) % span;
  }
  const float width = P.hi_f - P.lo_f;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long b = e / P.per_key;
    const uint32_t j = static_cast<uint32_t>(e - b * P.per_key);
    const long long* key = P.keys + b * P.key_stride;
    const uint32_t k0 = static_cast<uint32_t>(__ldg(key));
    const uint32_t k1 = static_cast<uint32_t>(__ldg(key + 1));
    switch (P.op) {
      case kCipher: {
        uint32_t x0 = 0, x1 = P.offset + j;
        threefry::threefry2x32(k0, k1, x0, x1);
        long long* out = static_cast<long long*>(P.out) + 2 * e;
        out[0] = x0;
        out[1] = x1;
        break;
      }
      case kBits:
        static_cast<long long*>(P.out)[e] = threefry::key_bits(k0, k1, j);
        break;
      case kUniform: {
        const uint32_t bits = threefry::key_bits(k0, k1, j);
        const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
        static_cast<float*>(P.out)[e] =
            fmaxf(P.lo_f, __fmaf_rn(f, width, P.lo_f));
        break;
      }
      default: {  // kRandint
        uint32_t a0 = 0, a1 = 0, c0 = 0, c1 = 1;
        threefry::threefry2x32(k0, k1, a0, a1);  // k1 of the inner split
        threefry::threefry2x32(k0, k1, c0, c1);  // k2
        const uint32_t higher = threefry::key_bits(a0, a1, j);
        const uint32_t lower = threefry::key_bits(c0, c1, j);
        const uint32_t off = ((higher % span) * mult + lower % span) % span;
        static_cast<int32_t*>(P.out)[e] = static_cast<int32_t>(
            static_cast<uint32_t>(static_cast<unsigned long long>(lo) + off));
        break;
      }
    }
  }
}

}  // namespace

// keys: n_keys int64 pairs on the device, key b's words at keys +
// b * key_stride (only the low 32 bits of each word are read); out:
// int64 [n_keys, per_key, 2] (kCipher), int64 [n_keys, per_key] (kBits),
// float32 (kUniform) or int32 (kRandint).
// lo_ptr / hi_ptr are null or point at one int32 (is64 = 0) or int64
// (is64 = 1) on the device.  One launch on `stream`; returns its error,
// or 0.
extern "C" int prng_launch(int op, const void* keys, long long n_keys,
                           long long key_stride, long long per_key,
                           unsigned offset, float lo_f, float hi_f,
                           long long lo_i, long long hi_i,
                           const void* lo_ptr, int lo_64, const void* hi_ptr,
                           int hi_64, void* out, void* stream) {
  if (op < kCipher || op > kRandint || n_keys < 1 || key_stride < 0 ||
      per_key < 1 || per_key > 0x100000000LL)
    return cudaErrorInvalidValue;
  const long long total = n_keys * per_key;
  if (total / per_key != n_keys) return cudaErrorInvalidValue;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  Params P;
  P.keys = static_cast<const long long*>(keys);
  P.n_keys = n_keys;
  P.key_stride = key_stride;
  P.per_key = per_key;
  P.offset = offset;
  P.op = op;
  P.lo_f = lo_f;
  P.hi_f = hi_f;
  P.lo_i = lo_i;
  P.hi_i = hi_i;
  P.lo_ptr = lo_ptr;
  P.hi_ptr = hi_ptr;
  P.lo_64 = lo_64;
  P.hi_64 = hi_64;
  P.out = out;
  prng_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* prng_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
