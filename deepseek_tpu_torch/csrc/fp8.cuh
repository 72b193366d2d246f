// F8E5M2 -> float32 for the fp8 bodies of qmm.cu and qmm_tiles.cu.
//
// An e5m2 byte is exactly the high byte of an IEEE half: the same sign and
// 5-bit exponent (bias 15), and its 2 mantissa bits are the half's top two.
// So one byte-permute puts two e5m2 bytes under two zero low bytes and
// gives a __half2 with no rounding; the half -> float conversion is exact
// too (subnormals, infinities and NaNs included).

#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

// the 16 e5m2 weights of one 16-byte load, in order, as float32
__device__ __forceinline__ void e5m2x16(const uint4& v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = __byte_perm(u[k], 0u, 0x1404u);   // bytes 0, 1
    const uint32_t hi = __byte_perm(u[k], 0u, 0x3424u);   // bytes 2, 3
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
    out[4 * k] = a.x;
    out[4 * k + 1] = a.y;
    out[4 * k + 2] = b.x;
    out[4 * k + 3] = b.y;
  }
}
