// F8E5M2 -> float32 for the fp8 bodies of qmm.cu, qmm_tiles.cu and fp8_mv.cu.
//
// An e5m2 byte is exactly the high byte of an IEEE half: the same sign and
// 5-bit exponent (bias 15), and its 2 mantissa bits are the half's top two.
// So one byte-permute puts two e5m2 bytes under two zero low bytes and
// gives a __half2 with no rounding; the half -> float conversion is exact
// too (subnormals, infinities and NaNs included).

#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

// the 4 e5m2 weights of one word, in order, as float32
__device__ __forceinline__ void e5m2x4(uint32_t u, float* out) {
  const uint32_t lo = __byte_perm(u, 0u, 0x1404u);   // bytes 0, 1
  const uint32_t hi = __byte_perm(u, 0u, 0x3424u);   // bytes 2, 3
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// the 16 e5m2 weights of one 16-byte load, in order, as float32
__device__ __forceinline__ void e5m2x16(const uint4& v, float* out) {
  e5m2x4(v.x, out);
  e5m2x4(v.y, out + 4);
  e5m2x4(v.z, out + 8);
  e5m2x4(v.w, out + 12);
}
