// Threefry-2x32 on the device, bit for bit with core/prng.py (and so with
// jax.random under jax_threefry_partitionable, jax 0.9.0).
//
//   block(key, (x0, x1))  20 rounds, rotations (13,15,26,6)/(17,29,16,24),
//                         key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA);
//   fold_in(key, d)       block(key, (0, d)); split(key)[i] = fold_in(key, i);
//   bits(key, j)          block(key, (hi32(j), lo32(j))), the words XORed;
//   uniform               mantissa (bits >> 9) | 0x3F800000 minus 1, times
//                         scale, plus lo, max(lo, .) on [lo, 1) with
//                         lo = nextafter(-1, 0): each op rounded on its own
//                         (torch runs them as separate kernels, so no FMA);
//   normal                erfinvf(u) * float32(sqrt 2).
//
// Every word op is uint32 arithmetic, which wraps as prng.py's masks do.
// The build must not use --use_fast_math: erfinvf is then the CUDA math
// library's precise erfinvf, the function torch.erfinv calls on the card.
#pragma once

#include <stdint.h>

namespace threefry {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds of the mix with the rotations r0..r3.
#define THREEFRY_ROUNDS(r0, r1, r2, r3) \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;     \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;     \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;     \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

// The Threefry-2x32 block: both output words for the counter (x0, x1).
__device__ __forceinline__ Key block(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0;
  x1 += k.k1;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k.k1; x1 += k2 + 1u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k.k0 + 2u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k.k0; x1 += k.k1 + 3u;
  THREEFRY_ROUNDS(17, 29, 16, 24)
  x0 += k.k1; x1 += k2 + 4u;
  THREEFRY_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k.k0 + 5u;
  return Key{x0, x1};
}

#undef THREEFRY_ROUNDS

// A key stored as prng.py stores it: two int64 holding uint32 words.
__device__ __forceinline__ Key load(const int64_t* words) {
  return Key{(uint32_t)words[0], (uint32_t)words[1]};
}

__device__ __forceinline__ void store(int64_t* words, Key k) {
  words[0] = (int64_t)k.k0;
  words[1] = (int64_t)k.k1;
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  return block(k, 0u, d);
}

// The 32 random bits of the element at flat index j.
__device__ __forceinline__ uint32_t bits(Key k, uint64_t j) {
  const Key b = block(k, (uint32_t)(j >> 32), (uint32_t)j);
  return b.k0 ^ b.k1;
}

// normal(key, shape) at flat index j, in float32.
__device__ __forceinline__ float normal(Key k, uint64_t j) {
  const float lo = -0x1.fffffep-1f;              // nextafter(-1, 0)
  const float scale = __fsub_rn(1.0f, lo);
  const float sqrt2 = 0x1.6a09e6p+0f;            // float32(sqrt(2))
  const float f = __fsub_rn(
      __uint_as_float((bits(k, j) >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, scale), lo));
  return __fmul_rn(erfinvf(u), sqrt2);
}

}  // namespace threefry
