// The nibble arithmetic shared by qmm.cu (the turbo bodies) and
// expert_ffn.cu (K7): an activation row staged in the stride-16 permuted
// order with its natural group sums, the byte-permute nibble floats (0.5 +
// u/256: the byte under the 0x3F exponent byte of 0.5f, an exact float
// whose offset cancels against the group sums), and the products of one
// 4-group quad of weight rows. nibble_mv.cu's header gives the plane
// layout.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// 0.5 + u/256 for the nibble held in one byte of `nib` (selector picks the
// byte into bits 16..23 under the 0x3F exponent byte of 0.5f)
__device__ __forceinline__ float nib_f(uint32_t nib, uint32_t sel) {
  return __uint_as_float(__byte_perm(nib, 0x3F000000u, sel));
}

__device__ __forceinline__ void bf16x4(uint2 v, float out[4]) {
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xFFFF0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

// Stage activation row xrow in shared memory with a block of THREADS
// threads: xs (n floats) in the stride-16 permuted order (position
// o*n16 + g = natural column 16g + o) and s16 (n/16 floats) the sums of
// its natural 16-column groups. The caller synchronizes the block after.
template <int THREADS>
__device__ __forceinline__ void stage_permuted(const float* __restrict__ x,
                                               int xrow, int n, float* xs,
                                               float* s16) {
  constexpr int kPro = 4;    // groups per thread per pass, loads in flight together
  const int n16 = n >> 4;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)xrow * n);
  for (int g0 = threadIdx.x; g0 < n16; g0 += THREADS * kPro) {
    float4 f[kPro][4];
#pragma unroll
    for (int j = 0; j < kPro; ++j) {
      const int g = min(g0 + j * THREADS, n16 - 1);   // clamped: loads unconditional
#pragma unroll
      for (int v = 0; v < 4; ++v) f[j][v] = __ldg(xr + g * 4 + v);
    }
#pragma unroll
    for (int j = 0; j < kPro; ++j) {
      const int g = g0 + j * THREADS;
      if (g >= n16) break;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        xs[(4 * v + 0) * n16 + g] = f[j][v].x;
        xs[(4 * v + 1) * n16 + g] = f[j][v].y;
        xs[(4 * v + 2) * n16 + g] = f[j][v].z;
        xs[(4 * v + 3) * n16 + g] = f[j][v].w;
        s += (f[j][v].x + f[j][v].y) + (f[j][v].z + f[j][v].w);
      }
      s16[g] = s;
    }
  }
}

// acc[rr] += the products of R weight rows' quad of groups g0..g0+3 with
// the staged activations: w[rr][o] the plane word at offset o*n16 + g0
// (o < 8; byte k = group g0 + k, low nibble offset o, high o + 8), av and
// cv the rows' bf16 scales and min terms of the 4 groups, xs and s16 the
// staged row, c0 = 128 + off. Per group, with t = sum x * (0.5 + u/256):
// sum x * (a*(u - off) - c) = a*(256 t - (128 + off) s16) - c s16.
template <int R, bool HAS_C>
__device__ __forceinline__ void knib_quad(const uint32_t (&w)[R][8],
                                          const uint2 (&av)[R],
                                          const uint2 (&cv)[R],
                                          const float* xs, const float* s16,
                                          int n16, int g0, float c0,
                                          float (&acc)[R]) {
  float4 xl[8], xh[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    xl[o] = *reinterpret_cast<const float4*>(xs + o * n16 + g0);
    xh[o] = *reinterpret_cast<const float4*>(xs + (o + 8) * n16 + g0);
  }
  const float4 s4 = *reinterpret_cast<const float4*>(s16 + g0);
  const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const uint32_t lo = w[rr][o] & 0x0F0F0F0Fu;
      const uint32_t hi = (w[rr][o] >> 4) & 0x0F0F0F0Fu;
      t0 = fmaf(xl[o].x, nib_f(lo, 0x7054u), t0);
      t0 = fmaf(xh[o].x, nib_f(hi, 0x7054u), t0);
      t1 = fmaf(xl[o].y, nib_f(lo, 0x7154u), t1);
      t1 = fmaf(xh[o].y, nib_f(hi, 0x7154u), t1);
      t2 = fmaf(xl[o].z, nib_f(lo, 0x7254u), t2);
      t2 = fmaf(xh[o].z, nib_f(hi, 0x7254u), t2);
      t3 = fmaf(xl[o].w, nib_f(lo, 0x7354u), t3);
      t3 = fmaf(xh[o].w, nib_f(hi, 0x7354u), t3);
    }
    const float t[4] = {t0, t1, t2, t3};
    float af[4];
    bf16x4(av[rr], af);
    float cf[4] = {0.f, 0.f, 0.f, 0.f};
    if (HAS_C) bf16x4(cv[rr], cf);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[rr] += af[k] * (256.f * t[k] - c0 * sv[k]) - cf[k] * sv[k];
  }
}
