// jax.random's threefry2x32 (prng.py) on the device, for the wavefront
// kernels (wavefront.cu, wavefront_bwd.cu): a lane derives its bounce's keys
// from the path key's words and draws each uniform at its flat index.

#pragma once

#include <cstdint>

namespace {

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// The hash of the counter (0, x1) under key k.
__device__ __forceinline__ Key threefry(Key k, uint32_t x1) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ Key load_key(const long long* key) {
  return {static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1])};
}

// jax.random.fold_in(k, data)
__device__ __forceinline__ Key fold_in(Key k, uint32_t data) { return threefry(k, data); }

// Element `idx` of jax.random.uniform(k, shape): the top 23 bits of b0 ^ b1
// as the mantissa of a float in [1, 2), minus 1.
__device__ __forceinline__ float uniform_at(Key k, uint32_t idx) {
  const Key h = threefry(k, idx);
  return __uint_as_float(((h.a ^ h.b) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace
