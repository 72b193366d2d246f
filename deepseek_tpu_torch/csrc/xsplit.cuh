// The x pre-pass and the pieces of the integer matvecs shared by
// packed_mv.cu (K5's and K2's packed bodies) and nibble_mv.cu (K1, K2's
// nibble bodies): each 16-column group of x, read in its own dtype and in
// the natural or the stride-16 permuted order, split into two int8 terms,
// x ~ s2 (254 a + b) with s1 = max|x_g| / 127, a = rint(x / s1), s2 = s1 /
// 254, b = rint((x - s1 a) / s2) (~15 bits of each x; the divisions are
// multiplies by rounded reciprocals of max|x_g|); the matvec that reads
// the terms launches behind the pre-pass with programmatic stream
// serialization and reads them with plain loads after griddepcontrol.wait.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplitThreads = 128;

// one 16-byte plane slab, streamed past L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// t[k] = byte k of each of w0..w3 (a 4 x 4 byte transpose)
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2,
                                           uint32_t w3, uint32_t t[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// natural column c of x row r (n wide), in dtype XK (0 f32, 1 f16, 2 bf16),
// from x in the natural (xperm 0) or the stride-16 permuted order (position
// o*n16 + g holds natural column 16g + o)
template <int XK>
__device__ __forceinline__ float x_at(const void* x, size_t r, int c, int n, int xperm) {
  const size_t i = r * n + (xperm ? (size_t)(c & 15) * (n >> 4) + (c >> 4) : (size_t)c);
  if constexpr (XK == 0) return __ldg(static_cast<const float*>(x) + i);
  const uint16_t v = __ldg(static_cast<const uint16_t*>(x) + i);
  if constexpr (XK == 1) return __half2float(__ushort_as_half(v));
  return __uint_as_float((uint32_t)v << 16);
}

// x (rows, n) -> the terms of group g = 16 sb + j of row b (a lane of the
// matvec takes superblock sb, so the lanes of a warp read one (row, term,
// j) slab of consecutive superblocks): terms[((2b + t) 16 + j) nsb + sb]
// the 16 int8 of term t (a, b) in natural column order, aux[(16b + j) nsb +
// sb] = (s2, sum: the f32 sum of x; else the int -off (254 sum a + sum b)
// as float bits). One thread a group.
template <int XK>
__global__ void __launch_bounds__(kSplitThreads)
xsplit_kernel(const void* __restrict__ x, int xperm, uint4* __restrict__ terms,
              float2* __restrict__ aux, int groups, int nsb, int off, int sum) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int i = blockIdx.x * kSplitThreads + threadIdx.x;   // (16 b + j) nsb + sb
  if (i >= groups) return;
  const int sb = i % nsb, bj = i / nsb, b = bj >> 4, j = bj & 15;
  const int n = nsb * 256, c0 = 256 * sb + 16 * j;
  float v[16];
  if (XK == 0 && !xperm) {
    const float4* xg = reinterpret_cast<const float4*>(static_cast<const float*>(x) +
                                                       (size_t)b * n + c0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = __ldg(xg + k);
      v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z; v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = x_at<XK>(x, b, c0 + k, n, xperm);
  }
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) m = fmaxf(m, fabsf(v[c]));
  // s1 = m / 127, s2 = s1 / 254 and the reciprocals, from one rounded 1 / m
  const float inv = m > 0.f ? __frcp_rn(m) : 0.f;
  const float s1 = __fmul_rn(m, 1.f / 127.f), s2 = __fmul_rn(s1, 1.f / 254.f);
  const float r1 = __fmul_rn(127.f, inv), r2 = __fmul_rn(32258.f, inv);
  uint32_t wa[4] = {0u, 0u, 0u, 0u}, wb[4] = {0u, 0u, 0u, 0u};
  int sa = 0, sbv = 0;
  float sx = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float a = rintf(__fmul_rn(v[c], r1));
    const float r = __fsub_rn(v[c], __fmul_rn(s1, a));
    const float bt = fminf(fmaxf(rintf(__fmul_rn(r, r2)), -127.f), 127.f);
    const int ia = (int)a, ib = (int)bt;
    wa[c >> 2] |= (uint32_t)(ia & 0xFF) << (8 * (c & 3));
    wb[c >> 2] |= (uint32_t)(ib & 0xFF) << (8 * (c & 3));
    sa += ia;
    sbv += ib;
    sx += v[c];
  }
  const size_t slab = (size_t)16 * nsb;
  terms[(size_t)b * 2 * slab + (size_t)j * nsb + sb] = make_uint4(wa[0], wa[1], wa[2], wa[3]);
  terms[((size_t)b * 2 + 1) * slab + (size_t)j * nsb + sb] =
      make_uint4(wb[0], wb[1], wb[2], wb[3]);
  aux[i] = make_float2(s2, sum ? sx : __int_as_float(-off * (254 * sa + sbv)));
}

// the pre-pass over x (rows, n) in dtype x_dtype into terms (2 * groups)
// and aux (groups), groups = rows * n/16
inline cudaError_t launch_xsplit(const void* x, int x_dtype, int xperm, uint4* terms,
                                 float2* aux, int groups, int n, int off, int sum,
                                 cudaStream_t st) {
  const int blocks = (groups + kSplitThreads - 1) / kSplitThreads;
  if (x_dtype == 0)
    xsplit_kernel<0><<<blocks, kSplitThreads, 0, st>>>(x, xperm, terms, aux, groups, n / 256,
                                                       off, sum);
  else if (x_dtype == 1)
    xsplit_kernel<1><<<blocks, kSplitThreads, 0, st>>>(x, xperm, terms, aux, groups, n / 256,
                                                       off, sum);
  else
    xsplit_kernel<2><<<blocks, kSplitThreads, 0, st>>>(x, xperm, terms, aux, groups, n / 256,
                                                       off, sum);
  return cudaGetLastError();
}

// one group's x terms and scalars for each x row
template <int NB>
struct XTerms {
  uint4 a[NB], b[NB];
  float2 s[NB];
};

// plain (coherent) loads: never moved above griddepcontrol.wait
template <int NB, bool EXPERTS>
__device__ __forceinline__ void load_x(XTerms<NB>& t, const uint4* terms, const float2* aux,
                                       int xrow, int j, int sb, int nsb) {
#pragma unroll
  for (int bb = 0; bb < NB; ++bb) {
    const size_t xr = EXPERTS ? xrow : bb;
    t.a[bb] = terms[((2 * xr) * 16 + j) * nsb + sb];
    t.b[bb] = terms[((2 * xr + 1) * 16 + j) * nsb + sb];
    t.s[bb] = aux[(xr * 16 + j) * nsb + sb];
  }
}

// kernel (a matvec that waits for the pre-pass) on blocks x threads,
// allowed to start before the pre-pass ends
template <typename Kernel, typename... Args>
cudaError_t launch_behind(Kernel kernel, int blocks, int threads, cudaStream_t st,
                          Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
