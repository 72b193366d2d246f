// Dequant + matrix-vector products for Hopper (sm_90a): K2's plain body
// (deepseek_tpu/ops/pallas/qmm.py:566 qmm_experts with the plain body
// :651: an f32, f16 or bf16 expert table, the MoE tables of a plain-weight
// checkpoint), K4, qmm's plain body (qmm.py:305, the large plain weights at
// <= 8 rows), K2's fp8 body (qmm.py:664, _fp8_body :260: fp8 expert tables
// and wv_b), and the turbo bodies of K5 and K2 (each before its kernels
// below). The nibble matvec (K1, K2's nibble bodies) is csrc/nibble_mv.cu,
// K5's fp8 matvec csrc/fp8_mv.cu, the packed bodies of K5 and K2
// csrc/packed_mv.cu.
//
// Bound: bytes everywhere: a decode matvec does 2 flops a weight, far below
// the card's ~295 flops/byte balance point, so the weight stream is the
// whole cost; each kernel's note says how it keeps up with it. The
// accumulation is float32 throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8.cuh"
#include "knib.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps per block
constexpr int kRows = 4;       // output rows per lane subgroup
constexpr int kMaxSmem = 232448;

// The turbo bodies of K5 (qmm.py:312 qmm with _q2kt_body :169, launched
// :378, and _q3kt_body :195, launched :385: Q2_K/Q3_K turbo projections at
// few rows) and K2 (qmm.py:566 qmm_experts, the same bodies chosen
// :630-637: turbo expert tables and the per-head wv_b). Both planes hold
// one int8 a weight; the activations come in natural order and the kernel
// makes what the TPU kernel took as inputs: Q2_K's group sums s16 over the
// natural row, Q3_K's permuted row (knib.cuh's stage_permuted, as K7).
//
//   Q2_K turbo, natural order, p = sc*q in 0..45, f32 super scales d,
//   bf16 min terms bm:
//     y[b, r] = sum_sb d[r, sb] * (x_sb . p_sb) - sum_g s16[b, g] * bm[r, g]
//   A lane takes two 16-column groups g, g + LPR at a time: one 16-byte
//   load a group and row (coalesced across the lanes), both groups' loads
//   issued before their arithmetic, t = sum_k x_k * (0.5 + p_k/256) by a
//   byte-permute and an FMA a weight (knib.cuh's nib_f float: p < 128
//   sits in mantissa bits 16..22), then per group
//     y += d[r, g/16] * (256 t - 128 s16[g]) - bm[r, g] * s16[g].
//   Q3_K turbo, permuted order (position o*n16 + g = natural column 16g + o,
//   scale group g), p = qlow + 4*hbit - 4 in [-4, 3], bf16 a = d*sc:
//     y[b, r] = sum_g a[r, g] * sum_o xp[b, o*n16 + g] * p[r, o*n16 + g]
//   A lane owns 16 consecutive groups g0.. (a 16-byte column at each of
//   the 16 offsets o*n16 + g0) and sums each group over its 16 copies
//   before the scale: t_g = sum_o xp * (0.5 + u/256), u = p + 4 by one
//   per-byte add (__vadd4), then once a group
//     y += a[r, g] * (256 t_g - 132 s16[g])     (sum xp*p = 256t - 128s - 4s)
//   so the scale costs one FMA per 16 weights, never a multiply a weight.
// Bound: bytes, 1 byte a weight (9.125 / 9 bits with the scales) at 2
// flops a weight; each weight costs a byte-permute and an FMA. kRows rows
// share every shared-memory read of the activations. f32 accumulation.

// Stage activation row xrow in shared memory in its natural order, and
// s16 (n/16 floats) the sums of its 16-column groups.
__device__ __forceinline__ void stage_natural(const float* __restrict__ x,
                                              int xrow, int n, float* xs,
                                              float* s16) {
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)xrow * n);
  for (int g = threadIdx.x; g < (n >> 4); g += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 f = __ldg(xr + g * 4 + v);
      reinterpret_cast<float4*>(xs)[g * 4 + v] = f;
      s += (f.x + f.y) + (f.z + f.w);
    }
    s16[g] = s;
  }
}

// t += x[0..3] . (0.5 + byte_k(w)/256) for the 4 bytes of w (each < 128)
__device__ __forceinline__ float dot4_nib(uint32_t w, float4 xv, float t) {
  t = fmaf(xv.x, nib_f(w, 0x7054u), t);
  t = fmaf(xv.y, nib_f(w, 0x7154u), t);
  t = fmaf(xv.z, nib_f(w, 0x7254u), t);
  return fmaf(xv.w, nib_f(w, 0x7354u), t);
}

template <int LPR>
__global__ void __launch_bounds__(kThreads)
q2kt_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ p,
                   const float* __restrict__ dsup, const uint16_t* __restrict__ bm,
                   const int32_t* __restrict__ idx, float* __restrict__ y,
                   int d, int n) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // n floats, natural order
  const int n16 = n >> 4;
  float* s16 = xs + n;                          // n16 group sums
  const int xrow = blockIdx.y;
  stage_natural(x, xrow, n, xs, s16);
  __syncthreads();

  const size_t e = idx != nullptr ? (size_t)idx[xrow] : 0;
  const size_t n256 = (size_t)(n >> 8);
  const uint8_t* pe = p + e * (size_t)d * n;
  const float* de = dsup + e * (size_t)d * n256;
  const uint16_t* be = bm + e * (size_t)d * n16;

  constexpr int kSub = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int sl = lane % LPR;
  const int sub = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kSub
                  + lane / LPR;
  const int row0 = sub * kRows;

  float acc[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
  // two groups a step (g and g + LPR), all their loads issued before the
  // arithmetic of either, so twice the bytes are in flight a lane
  for (int g = sl; g < n16; g += 2 * LPR) {
    const int ng = g + LPR < n16 ? 2 : 1;
    uint4 w[2][kRows];
    float dv[2][kRows], bv[2][kRows];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int gu = min(g + u * LPR, n16 - 1);          // clamped: used if u < ng
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const size_t r = (size_t)min(row0 + rr, d - 1);  // clamped: stores masked
        w[u][rr] = __ldg(reinterpret_cast<const uint4*>(pe + r * n) + gu);
        dv[u][rr] = __ldg(de + r * n256 + (gu >> 4));
        bv[u][rr] = __uint_as_float((uint32_t)__ldg(be + r * n16 + gu) << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u >= ng) break;
      const int gu = g + u * LPR;
      const float4* xg = reinterpret_cast<const float4*>(xs) + gu * 4;
      const float4 x0 = xg[0], x1 = xg[1], x2 = xg[2], x3 = xg[3];
      const float s = s16[gu];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        // two partial sums: shorter dependent FMA chains
        const float t = dot4_nib(w[u][rr].y, x1, dot4_nib(w[u][rr].x, x0, 0.f))
                        + dot4_nib(w[u][rr].w, x3, dot4_nib(w[u][rr].z, x2, 0.f));
        acc[rr] += dv[u][rr] * (256.f * t - 128.f * s) - bv[u][rr] * s;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int m = LPR / 2; m > 0; m >>= 1)
      acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], m);
  }
  if (sl == 0) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = row0 + rr;
      if (r < d) y[(size_t)xrow * d + r] = acc[rr];
    }
  }
}

template <int LPR>
__global__ void __launch_bounds__(kThreads)
q3kt_matvec_kernel(const float* __restrict__ x, const uint8_t* __restrict__ p,
                   const uint16_t* __restrict__ a, const int32_t* __restrict__ idx,
                   float* __restrict__ y, int d, int n) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // n floats, permuted order
  const int n16 = n >> 4;
  float* s16 = xs + n;                          // n16 group sums
  const int xrow = blockIdx.y;
  stage_permuted<kThreads>(x, xrow, n, xs, s16);
  __syncthreads();

  const size_t e = idx != nullptr ? (size_t)idx[xrow] : 0;
  const uint8_t* pe = p + e * (size_t)d * n;
  const uint16_t* ae = a + e * (size_t)d * n16;

  constexpr int kSub = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int sl = lane % LPR;
  const int sub = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kSub
                  + lane / LPR;
  const int row0 = sub * kRows;
  const int nb = n >> 8;                        // 16-group blocks per row

  float acc[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
  for (int jb = sl; jb < nb; jb += LPR) {
    const int g0 = jb << 4;
    float t[kRows][16];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int k = 0; k < 16; ++k) t[rr][k] = 0.f;
#pragma unroll 2
    for (int o = 0; o < 16; ++o) {
      uint4 w[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const size_t r = (size_t)min(row0 + rr, d - 1);
        w[rr] = __ldg(reinterpret_cast<const uint4*>(pe + r * n + (size_t)o * n16 + g0));
      }
      const float4* xo = reinterpret_cast<const float4*>(xs + o * n16 + g0);
      const float4 xv[4] = {xo[0], xo[1], xo[2], xo[3]};
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const uint32_t u[4] = {__vadd4(w[rr].x, 0x04040404u), __vadd4(w[rr].y, 0x04040404u),
                               __vadd4(w[rr].z, 0x04040404u), __vadd4(w[rr].w, 0x04040404u)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xq[4] = {xv[q].x, xv[q].y, xv[q].z, xv[q].w};
          t[rr][4 * q + 0] = fmaf(xq[0], nib_f(u[q], 0x7054u), t[rr][4 * q + 0]);
          t[rr][4 * q + 1] = fmaf(xq[1], nib_f(u[q], 0x7154u), t[rr][4 * q + 1]);
          t[rr][4 * q + 2] = fmaf(xq[2], nib_f(u[q], 0x7254u), t[rr][4 * q + 2]);
          t[rr][4 * q + 3] = fmaf(xq[3], nib_f(u[q], 0x7354u), t[rr][4 * q + 3]);
        }
      }
    }
    float sv[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(s16 + g0)[q];
      sv[4 * q] = f.x; sv[4 * q + 1] = f.y; sv[4 * q + 2] = f.z; sv[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const size_t r = (size_t)min(row0 + rr, d - 1);
      const uint4* ar = reinterpret_cast<const uint4*>(ae + r * n16 + g0);
      const uint4 a0 = __ldg(ar), a1 = __ldg(ar + 1);
      float af[16];
      bf16x4(make_uint2(a0.x, a0.y), af);
      bf16x4(make_uint2(a0.z, a0.w), af + 4);
      bf16x4(make_uint2(a1.x, a1.y), af + 8);
      bf16x4(make_uint2(a1.z, a1.w), af + 12);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        acc[rr] = fmaf(af[k], 256.f * t[rr][k] - 132.f * sv[k], acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int m = LPR / 2; m > 0; m >>= 1)
      acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], m);
  }
  if (sl == 0) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = row0 + rr;
      if (r < d) y[(size_t)xrow * d + r] = acc[rr];
    }
  }
}

template <int LPR, bool Q3>
cudaError_t launch_turbo(const float* x, const uint8_t* p, const float* dsup,
                         const uint16_t* a, const int32_t* idx, float* y,
                         int rows_x, int d, int n, cudaStream_t stream) {
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    cudaError_t err;
    if constexpr (Q3)
      err = cudaFuncSetAttribute(q3kt_matvec_kernel<LPR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    else
      err = cudaFuncSetAttribute(q2kt_matvec_kernel<LPR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  const size_t smem = (size_t)(n + n / 16) * sizeof(float);
  const int rows_per_block = (kThreads / 32) * (32 / LPR) * kRows;
  dim3 grid((d + rows_per_block - 1) / rows_per_block, rows_x);
  if constexpr (Q3)
    q3kt_matvec_kernel<LPR><<<grid, kThreads, smem, stream>>>(x, p, a, idx, y, d, n);
  else
    q2kt_matvec_kernel<LPR><<<grid, kThreads, smem, stream>>>(x, p, dsup, a, idx, y, d, n);
  return cudaGetLastError();
}

// lanes per row from the units a row has (Q2_K: 16-column groups; Q3_K:
// 16-group blocks), so that short rows do not leave most lanes idle
template <bool Q3>
cudaError_t dispatch_turbo(const float* x, const uint8_t* p, const float* dsup,
                           const uint16_t* a, const int32_t* idx, float* y,
                           int rows_x, int d, int n, cudaStream_t stream) {
  const int units = Q3 ? n / 256 : n / 16;
  if (units >= 24)
    return launch_turbo<32, Q3>(x, p, dsup, a, idx, y, rows_x, d, n, stream);
  if (units >= 6)
    return launch_turbo<8, Q3>(x, p, dsup, a, idx, y, rows_x, d, n, stream);
  return launch_turbo<2, Q3>(x, p, dsup, a, idx, y, rows_x, d, n, stream);
}

// K2's plain and fp8 bodies: y[b, r] = sum_c x[b, c] * float(W[idx[b]][r, c]),
// the table read in its own dtype and widened to f32 (the Pallas body's
// astype(float32)). Bound: bytes, 2 flops per table element. A warp owns
// an item of kPlainRows table rows of one pair b and walks their columns
// in 16-byte vectors, coalesced across its lanes, kPlainUnroll vectors of
// each row (8 loads) in flight a lane. Nothing is staged: a lane always
// reads the same slices of x, straight from L1/L2 beside the table
// vectors, so a warp's first table loads leave at once (no block-wide
// copy of the row and barrier before them). The grid is persistent:
// as many warps as the card holds at once, fewer where that spreads the
// items more evenly, each walking items a grid apart, so no partial last
// wave of blocks idles the card; consecutive warps take consecutive rows
// of one pair, which share x in L1. 64 registers, four blocks an SM: at
// DeepSeek-V2-Lite's w2s (8 pairs of 2048 x 1408) every item then has a
// warp of its own (at 76 registers, three blocks, a warp took two).
//
// WT = uint8_t is the fp8 body (qmm.py:655-666, _fp8_body :260): F8E5M2
// weights with f32 inverse scales s (E, ceil(d/b0), ceil(n/b1)), y[b, r] =
// sum over the column blocks cb of s[idx[b]][r / b0][cb] * sum_{c in cb}
// x[b, c] * float(W[r, c]). A 16-weight vector never straddles a block
// (b1 % 16 == 0), so its partial sum is scaled once, on the output side as
// the TPU body does (one FMA per 16 weights); ragged grids need nothing but
// the index. Per weight: half a byte-permute and one half -> float convert
// (fp8.cuh) and the FMA, about a third of the SM's issue rate at the byte
// bound; a 16-byte vector is 16 weights against 64 bytes of x, so the x
// vectors are loaded after the table's (x comes from L1) and the block
// bound is two an SM (128 registers: at three, 80 registers spilled), 16
// warps with 8 table loads of 16 bytes in flight a lane.
template <typename WT>
__device__ __forceinline__ void widen(const uint4& v, float* out);

template <>
__device__ __forceinline__ void widen<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& v, float* out) {
  bf16x4(make_uint2(v.x, v.y), out);
  bf16x4(make_uint2(v.z, v.w), out + 4);
}

template <>
__device__ __forceinline__ void widen<uint8_t>(const uint4& v, float* out) {
  e5m2x16(v, out);                               // F8E5M2 bytes
}

template <>
__device__ __forceinline__ void widen<__half>(const uint4& v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[k]));
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

constexpr int kPlainThreads = 256;
constexpr int kPlainRows = 4;      // table rows a warp item
constexpr int kPlainUnroll = 2;    // 16-byte vectors of each row in flight a lane

// blocks an SM the launch bounds ask for (registers: 64 a thread at 4;
// the fp8 body's 16 x values a vector need more: 128 at 2, no spill)
template <typename WT>
constexpr int plain_blocks() { return sizeof(WT) == 1 ? 2 : 4; }

template <typename WT>
__global__ void __launch_bounds__(kPlainThreads, plain_blocks<WT>())
plain_matvec_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                    const float* __restrict__ s, const int32_t* __restrict__ idx,
                    float* __restrict__ y, int rows_x, int d, int n, int b0,
                    int vb, int vshift) {
  constexpr int kVec = 16 / sizeof(WT);          // table elements per load
  constexpr bool kFp8 = sizeof(WT) == 1;         // F8E5M2 with block scales
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kPlainThreads / 32);
  const int groups = (d + kPlainRows - 1) / kPlainRows;
  const int items = rows_x * groups, nv = n / kVec;
  const int g0 = (d + b0 - 1) / b0, g1 = (n / 16 + vb - 1) / vb;   // fp8 scale grid
  for (int item = blockIdx.x * (kPlainThreads / 32) + (threadIdx.x >> 5); item < items;
       item += warps) {
    const int b = item / groups, row0 = (item - b * groups) * kPlainRows;
    const size_t e = (size_t)idx[b];
    const WT* we = w + e * d * n;
    const uint4* wr[kPlainRows];
    const float* sr[kPlainRows];                 // fp8: each row's scale row
#pragma unroll
    for (int rr = 0; rr < kPlainRows; ++rr) {    // clamped: stores are masked
      const int r = min(row0 + rr, d - 1);
      wr[rr] = reinterpret_cast<const uint4*>(we + (size_t)r * n);
      if constexpr (kFp8) sr[rr] = s + (e * g0 + r / b0) * g1;
    }
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)b * n);
    float acc[kPlainRows];
#pragma unroll
    for (int rr = 0; rr < kPlainRows; ++rr) acc[rr] = 0.f;
    for (int v0 = lane; v0 < nv; v0 += 32 * kPlainUnroll) {
      uint4 raw[kPlainUnroll][kPlainRows];
      float4 xv[kPlainUnroll][kVec / 4];
#pragma unroll
      for (int u = 0; u < kPlainUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) {
#pragma unroll
          for (int rr = 0; rr < kPlainRows; ++rr) raw[u][rr] = __ldg(wr[rr] + v);
          if constexpr (!kFp8) {
#pragma unroll
            for (int k = 0; k < kVec / 4; ++k) xv[u][k] = __ldg(xr + v * (kVec / 4) + k);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPlainUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v >= nv) break;
        if constexpr (kFp8) {
#pragma unroll
          for (int k = 0; k < kVec / 4; ++k) xv[u][k] = __ldg(xr + v * (kVec / 4) + k);
        }
        const float* xf = reinterpret_cast<const float*>(xv[u]);
        // fp8: the column block of vector v
        [[maybe_unused]] const int cb = vshift >= 0 ? v >> vshift : v / vb;
#pragma unroll
        for (int rr = 0; rr < kPlainRows; ++rr) {
          float wv[kVec];
          widen<WT>(raw[u][rr], wv);
          if constexpr (kFp8) {
            float t = 0.f;
#pragma unroll
            for (int k = 0; k < kVec; ++k) t = fmaf(xf[k], wv[k], t);
            acc[rr] = fmaf(t, __ldg(sr[rr] + cb), acc[rr]);
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) acc[rr] = fmaf(xf[k], wv[k], acc[rr]);
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kPlainRows; ++rr) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1)
        acc[rr] += __shfl_xor_sync(0xffffffffu, acc[rr], m);
    }
    if (lane == 0) {
#pragma unroll
      for (int rr = 0; rr < kPlainRows; ++rr) {
        const int r = row0 + rr;
        if (r < d) y[(size_t)b * d + r] = acc[rr];
      }
    }
  }
}

// s, b0, b1: the fp8 body's scales and blocks (WT = uint8_t), unused
// otherwise
template <typename WT>
cudaError_t launch_plain(const float* x, const void* w, const int32_t* idx,
                         float* y, int rows_x, int d, int n,
                         cudaStream_t stream, const float* s = nullptr,
                         int b0 = 1, int b1 = 16) {
  static int max_warps = 0;        // warps the card holds at once
  if (max_warps == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, plain_matvec_kernel<WT>, kPlainThreads, 0);
    if (err != cudaSuccess) return err;
    max_warps = max(1, per_sm) * sms * (kPlainThreads / 32);
  }
  // the fewest warps that keep the most items a warp walks
  const long long items = (long long)rows_x * ((d + kPlainRows - 1) / kPlainRows);
  const long long per = (items + max_warps - 1) / max_warps;
  const long long warps = (items + per - 1) / per;
  const int grid = (int)((warps + kPlainThreads / 32 - 1) / (kPlainThreads / 32));
  // 16-weight vectors a column block holds, and its log2 where it is a
  // power of two (a shift in place of a division), else -1
  const int vb = b1 / 16, vshift = (vb & (vb - 1)) ? -1 : __builtin_ctz(vb);
  plain_matvec_kernel<WT><<<grid, kPlainThreads, 0, stream>>>(
      x, static_cast<const WT*>(w), s, idx, y, rows_x, d, n, b0, vb, vshift);
  return cudaGetLastError();
}

// K4, the plain-weight matvec (qmm.py:305 _plain_body, launched at :329 for
// plain weights of at least 32 MiB at <= 8 activation rows: the lm_head and
// the large dense FFN weights): y[b, r] = sum_c x[b, c] * float(W[r, c]).
// Bound: bytes; every weight row is read once for all NB rows of x. A
// block handles tiles of kMvRows = 8 output rows; its 8 warps are 2 row
// groups of 4 rows x 4 column quarters, so the contraction of a long row
// (w2: 10944 columns, 21 KB) is split across the warps of the block and
// reduced in shared memory. A lane reads 16-byte weight vectors
// (coalesced: a warp instruction covers 512 contiguous bytes of one row),
// two column steps of its 4 rows in flight at once, widened to f32 in
// registers. The NB x rows are staged in shared memory a column chunk at a
// time (8 rows of 10944 floats would not fit), at most 64 KB a chunk. The
// grid holds only as many blocks as fit on the card at once, each walking
// row tiles: where x fits in one chunk it is staged once per block, not
// once per tile (at 8 rows, restaging it for every 8-row tile would read
// twice the weight's bytes from L2).
constexpr int kMvThreads = 256;
constexpr int kMvRows = 8;          // output rows per tile
constexpr int kMvRowsPerWarp = 4;
constexpr int kMvQuarters = 4;      // column splits per row group
constexpr int kMvSmemFloats = 16384;
constexpr int kMvMaxX = 8;          // x rows a launch at most (dispatch_mv)

template <typename WT, int NB>
__global__ void __launch_bounds__(kMvThreads)
plain_mv_kernel(const float* __restrict__ x, const WT* __restrict__ w,
                float* __restrict__ y, int d, int n, int chunk) {
  constexpr int kVec = 16 / sizeof(WT);
  constexpr int kStride = 32 * kMvQuarters;      // vectors between a lane's steps
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [NB][chunk]
  __shared__ float red[kMvQuarters][kMvRows][NB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / kMvQuarters, cq = warp % kMvQuarters;
  const bool one_chunk = chunk >= n;
  auto stage = [&](int c0, int cc) {
    for (int i = tid; i < NB * (cc / 4); i += kMvThreads) {
      const int b = i / (cc / 4), j = i - b * (cc / 4);
      reinterpret_cast<float4*>(xs + b * chunk)[j] =
          __ldg(reinterpret_cast<const float4*>(x + (size_t)b * n + c0) + j);
    }
  };
  if (one_chunk) stage(0, n);

  const int tiles = (d + kMvRows - 1) / kMvRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kMvRows + rg * kMvRowsPerWarp;
    const WT* wr[kMvRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kMvRowsPerWarp; ++rr) {
      const int r = min(row0 + rr, d - 1);       // clamped: stores masked
      wr[rr] = w + (size_t)r * n;
    }

    float acc[kMvRowsPerWarp][NB];
#pragma unroll
    for (int rr = 0; rr < kMvRowsPerWarp; ++rr)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[rr][b] = 0.f;

    for (int c0 = 0; c0 < n; c0 += chunk) {
      const int cc = min(chunk, n - c0);
      if (!one_chunk) {
        __syncthreads();                   // the previous chunk is consumed
        stage(c0, cc);
      }
      __syncthreads();
      const int nv = cc / kVec;
      for (int vi = cq * 32 + lane; vi < nv; vi += 2 * kStride) {
        const bool two = vi + kStride < nv;
        uint4 raw[2][kMvRowsPerWarp];
#pragma unroll
        for (int rr = 0; rr < kMvRowsPerWarp; ++rr) {
          const uint4* src = reinterpret_cast<const uint4*>(wr[rr] + c0);
          raw[0][rr] = __ldg(src + vi);
          raw[1][rr] = two ? __ldg(src + vi + kStride) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const int col = (vi + u * kStride) * kVec;
          // the 4 rows' weights widened once; the x rows one at a time
          float wv[kMvRowsPerWarp][kVec];
#pragma unroll
          for (int rr = 0; rr < kMvRowsPerWarp; ++rr) widen<WT>(raw[u][rr], wv[rr]);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            float xv[kVec];
#pragma unroll
            for (int k = 0; k < kVec; k += 4) {
              const float4 f = *reinterpret_cast<const float4*>(xs + b * chunk + col + k);
              xv[k] = f.x; xv[k + 1] = f.y; xv[k + 2] = f.z; xv[k + 3] = f.w;
            }
#pragma unroll
            for (int rr = 0; rr < kMvRowsPerWarp; ++rr) {
#pragma unroll
              for (int k = 0; k < kVec; ++k)
                acc[rr][b] = fmaf(xv[k], wv[rr][k], acc[rr][b]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < kMvRowsPerWarp; ++rr)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float s = acc[rr][b];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (lane == 0) red[cq][rg * kMvRowsPerWarp + rr][b] = s;
      }
    __syncthreads();
    if (tid < kMvRows * NB) {
      const int r = tid / NB, b = tid % NB;
      const int row = tile * kMvRows + r;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMvQuarters; ++q) s += red[q][r][b];
      if (row < d) y[(size_t)b * d + row] = s;
    }
    __syncthreads();                       // red is read before the next tile
  }
}

template <typename WT, int NB>
cudaError_t launch_mv(const float* x, const void* w, float* y, int d, int n,
                      cudaStream_t stream) {
  // the x chunk: a multiple of 64 columns (whole weight vectors), <= 64 KB
  const int chunk = min(n, kMvSmemFloats / NB / 64 * 64);
  const size_t smem = (size_t)NB * chunk * sizeof(float);
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        plain_mv_kernel<WT, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMvSmemFloats * (int)sizeof(float));
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  // as many blocks as the card holds at once with this launch's x chunk
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, plain_mv_kernel<WT, NB>, kMvThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid = min((d + kMvRows - 1) / kMvRows, max(1, per_sm) * sms);
  plain_mv_kernel<WT, NB><<<grid, kMvThreads, smem, stream>>>(
      x, static_cast<const WT*>(w), y, d, n, chunk);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch_mv(const float* x, const void* w, float* y, int rows_x, int d,
                        int n, cudaStream_t stream) {
  switch (rows_x) {
    case 1: return launch_mv<WT, 1>(x, w, y, d, n, stream);
    case 2: return launch_mv<WT, 2>(x, w, y, d, n, stream);
    case 3: return launch_mv<WT, 3>(x, w, y, d, n, stream);
    case 4: return launch_mv<WT, 4>(x, w, y, d, n, stream);
    case 5: return launch_mv<WT, 5>(x, w, y, d, n, stream);
    case 6: return launch_mv<WT, 6>(x, w, y, d, n, stream);
    case 7: return launch_mv<WT, 7>(x, w, y, d, n, stream);
    case 8: return launch_mv<WT, 8>(x, w, y, d, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (rows_x, d) f32 = x (rows_x, n) f32 @ W (d, n).T, W in f32 (kind 2),
// f16 (3) or bf16 (4), contiguous and 16-byte aligned (K4). Needs 1 <=
// rows_x <= 8 and n % 64 == 0. Returns a cudaError_t; the launch is
// asynchronous on `stream`.
extern "C" int plain_mv(const void* x, const void* w, int kind, void* y,
                        int rows_x, int d, int n, void* stream) {
  if (rows_x < 1 || rows_x > kMvMaxX || d <= 0 || n <= 0 || n % 64 != 0 ||
      kind < 2 || kind > 4)
    return (int)cudaErrorInvalidValue;
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == 2) return (int)dispatch_mv<float>(xs, w, ys, rows_x, d, n, st);
  if (kind == 3) return (int)dispatch_mv<__half>(xs, w, ys, rows_x, d, n, st);
  return (int)dispatch_mv<__nv_bfloat16>(xs, w, ys, rows_x, d, n, st);
}

// y (rows_x, d) f32 = turbo matvec of x (rows_x, n) f32 (natural order).
// kind 0 = Q2_K turbo: p (E, d, n) int8 in natural column order, dsup
// (E, d, n/256) f32, a = bm (E, d, n/16) bf16; kind 1 = Q3_K turbo: p in
// the permuted order, a (E, d, n/16) bf16, dsup null. idx (rows_x,) int32
// selects the expert of each row (K2), or is null with E = 1 (K5). Needs
// n % 256 == 0 and 16-byte aligned planes. Returns a cudaError_t; the
// launch is asynchronous on `stream`.
extern "C" int turbo_matvec(const void* x, int kind, const void* p,
                            const void* dsup, const void* a, const void* idx,
                            void* y, int rows_x, int d, int n, void* stream) {
  if (rows_x <= 0 || rows_x > 65535 || d <= 0 || n <= 0 || n % 256 != 0 ||
      (size_t)(n + n / 16) * sizeof(float) > (size_t)kMaxSmem ||
      kind < 0 || kind > 1 || p == nullptr || a == nullptr ||
      (kind == 0 && dsup == nullptr))
    return (int)cudaErrorInvalidValue;
  auto xs = static_cast<const float*>(x);
  auto ps = static_cast<const uint8_t*>(p);
  auto ds = static_cast<const float*>(dsup);
  auto as = static_cast<const uint16_t*>(a);
  auto is = static_cast<const int32_t*>(idx);
  auto ys = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    return (int)dispatch_turbo<true>(xs, ps, ds, as, is, ys, rows_x, d, n, st);
  return (int)dispatch_turbo<false>(xs, ps, ds, as, is, ys, rows_x, d, n, st);
}

// y (rows_x, d) f32 = x (rows_x, n) f32 against the plain table W (E, d, n)
// in f32 (kind 2), f16 (3) or bf16 (4); idx (rows_x,) int32 selects the
// expert of each row (K2's plain body). Needs n % 8 == 0 and a 16-byte
// aligned table. Returns a cudaError_t; the launch is asynchronous.
extern "C" int plain_matvec(const void* x, const void* w, int kind,
                            const void* idx, void* y, int rows_x, int d, int n,
                            void* stream) {
  if (rows_x <= 0 || rows_x > 65535 || d <= 0 || n <= 0 || n % 8 != 0 ||
      kind < 2 || kind > 4 || idx == nullptr)
    return (int)cudaErrorInvalidValue;
  auto xs = static_cast<const float*>(x);
  auto is = static_cast<const int32_t*>(idx);
  auto ys = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == 2) return (int)launch_plain<float>(xs, w, is, ys, rows_x, d, n, st);
  if (kind == 3) return (int)launch_plain<__half>(xs, w, is, ys, rows_x, d, n, st);
  return (int)launch_plain<__nv_bfloat16>(xs, w, is, ys, rows_x, d, n, st);
}

// y (rows_x, d) f32 = x (rows_x, n) f32 against the F8E5M2 table W (E, d,
// n) with f32 inverse scales s (E, ceil(d/b0), ceil(n/b1)); idx (rows_x,)
// int32 selects the expert of each row (K2's fp8 body, the persistent
// plain_matvec_kernel). Needs n % 16 == 0, b1 % 16 == 0 and a 16-byte
// aligned W. Returns a cudaError_t; the launch is asynchronous on
// `stream`.
extern "C" int fp8_matvec(const void* x, const void* w, const void* s,
                          const void* idx, void* y, int rows_x, int d, int n,
                          int b0, int b1, void* stream) {
  if (rows_x <= 0 || rows_x > 65535 || d <= 0 || n <= 0 || n % 16 != 0 ||
      b0 <= 0 || b1 <= 0 || b1 % 16 != 0 || idx == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_plain<uint8_t>(
      static_cast<const float*>(x), w, static_cast<const int32_t*>(idx),
      static_cast<float*>(y), rows_x, d, n, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(s), b0, b1);
}
