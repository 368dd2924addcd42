// Threefry-2x32 (20 rounds) for the kernels that draw jax.random's bits.
//
// jax._src.prng.threefry_2x32 bit for bit, in jax's partitionable layout:
//   bits(key, shape)[j]  = o0 ^ o1  with (o0, o1) = threefry(key, (0, j))
//   split(key, n)[j]     = (o0, o1) of the same call
//   fold_in(key, d)      = threefry(key, (0, d))
// for the flat position j.  amper_sample.cu (the in-kernel pick) and
// prng.cu (the key derivations and draws of repro_torch.prng) share this
// one copy of the cipher.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32, 20 rounds: jax._src.prng.threefry_2x32 bit for bit.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// bits(key)[j] = o0 ^ o1 of threefry(key, (0, j)); split(key)[j] is
// (o0, o1) of the same call.
__device__ __forceinline__ uint32_t key_bits(uint32_t k0, uint32_t k1,
                                             uint32_t j) {
  uint32_t a0 = 0, a1 = j;
  threefry2x32(k0, k1, a0, a1);
  return a0 ^ a1;
}

}  // namespace threefry
