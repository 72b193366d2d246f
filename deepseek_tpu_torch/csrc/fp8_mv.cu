// K5's fp8 matvec for Hopper (sm_90a): qmm.py:312 qmm with _fp8_body :260,
// pallas_call :418: blockwise F8E5M2 projections at 1-4 rows, and at any
// rows, four a pass, where the column blocks are no multiple of 64:
//
//   y[b, r] = sum_cb s[r / b0, cb] * sum_{c in cb} x[b, c] * w[r, c].
//
// Bound: bytes: one e5m2 byte a weight, 2 flops for each x row. At 3.35
// TB/s the weight streams 3.35e12 bytes a second against ~3.0e13 lane
// instructions a second the SMs issue: ~9 instructions a weight. The design:
//  - f32 products: an e5m2 byte is the high byte of a half, so byte
//    permutes and half -> float conversions widen it exactly (fp8.cuh: 2
//    permutes and 4 conversions a word of 4 weights), and each x row takes
//    4 FMAs a word and one more to scale the word's sum: ~3 instructions a
//    weight at one x row, ~6 at four, well inside the issue rate, so the
//    products need no tensor cores. (A version on mma.sync, exact bf16
//    weights against x as bf16 hi + lo columns, had to bring 16-row tiles
//    into the MMA's fragment layout through a shared-memory ring, and was
//    slower than the parent's kernel at one f32 x row on six of V2-Lite's
//    seven shapes.)
//  - coalesced words: a lane takes words j = 32 k + lane of its row
//    (columns 4j..4j+3), so each warp load reads 128 consecutive weight
//    bytes (streamed past L1: read once) and 512 (f32) or 256 (f16, bf16)
//    consecutive bytes of each x row, whole L1 lines; x is read in its own
//    dtype (a bf16 or f16 x widens exactly: no cast launch) straight from
//    L1/L2, after the step's weight loads are issued: nothing is staged and
//    no barrier is taken;
//  - the scales outside the products: a word's 4 columns lie in one block
//    (b1 % 16 == 0), whose scale multiplies the word's sum; at b1 = 128 the
//    128 columns of a warp load are one block, so its scale is one
//    broadcast load;
//  - each weight byte read once a call for all 1-4 x rows;
//  - a persistent grid of warps, a weight row a warp item: as many warps as
//    the card holds at the launch bounds (the occupancy API), fewer where
//    that spreads the rows more evenly (every warp walks per or per - 1
//    rows): no partial last wave; blocks of two warps, so that a short
//    weight (V2-Lite's wkv_a, 576 rows) still reaches every SM;
//  - a warp streams: its next step's words (the next 1024 columns of its
//    row, or the first of its next row) are loaded before this step's
//    arithmetic, into a second buffer (the two swap roles: a register copy
//    of loaded words would wait for their load and leave one step in
//    flight).
// f32 accumulation; a row's 32 lanes meet in a butterfly of shuffles.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8.cuh"

namespace {

constexpr int kThreads = 64;         // 2 warps a block
constexpr int kMvRowsX = 4;          // x rows a pass at most
constexpr int kWords = 8;            // 4-byte weight words a lane loads a step
constexpr int kBlocksFew = 12;       // blocks an SM (launch bounds) at 1-2 x rows
constexpr int kBlocksMany = 8;       // at 3-4

// one weight word, streamed past L1
__device__ __forceinline__ uint32_t ld_stream(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// 4 consecutive x values at p in dtype XK (0 f32, 1 f16, 2 bf16), widened
// exactly
template <int XK>
__device__ __forceinline__ float4 x_word(const char* p) {
  if constexpr (XK == 0) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    if constexpr (XK == 1) {
      const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
      const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
      return make_float4(a.x, a.y, b.x, b.y);
    } else {
      return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                         __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
    }
  }
}

// the scale blocks: b0 rows by b1 columns, g1 blocks a row of the grid;
// q, r = 128 / b1, 128 % b1 (the 128 columns between a lane's words)
struct Fp8Grid {
  int b0, b1, g1, q, r;
};

// the first `live` of a lane's words of one step, from wl (its first word;
// each next one 128 bytes on); live = kWords compiles without a guard
__device__ __forceinline__ void load_words(uint32_t (&u)[kWords], const uint8_t* wl, int live) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) u[k] = k < live ? ld_stream(wl + 128 * k) : 0u;
}

// how many of its words of the step from word j0 a lane has in a row of nw
__device__ __forceinline__ int words_live(int j0, int nw) {
  const int left = nw - j0 - (int)(threadIdx.x & 31);
  return left <= 0 ? 0 : min(kWords, (left + 31) >> 5);
}

// one step's products: the first `live` of the lane's words u (word k at
// column c + 128 k; x row b at xl + b n values) against NB x rows, each
// word's 4-term sum scaled by its block (row block's scales at sr) into
// acc. B128 (b1 = 128): word k's block is the step's first plus k, the same
// for every lane; else the block is followed by q, r steps.
template <int XK, int NB, bool B128>
__device__ __forceinline__ void fp8_step(float (&acc)[NB], const uint32_t (&u)[kWords],
                                         const char* xl, int n, int c, const float* sr,
                                         const Fp8Grid& gr, int live) {
  constexpr int kX = XK == 0 ? 4 : 2;            // bytes an x value
  const char* xb[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) xb[b] = xl + (size_t)b * n * kX;
  const float* sp = sr + (B128 ? c >> 7 : c / gr.b1);
  int rem = B128 ? 0 : c % gr.b1;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    if (k < live) {
      const float sc = __ldg(B128 ? sp + k : sp);
      float wv[4];
      e5m2x4(u[k], wv);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 xv = x_word<XK>(xb[b] + 128 * k * kX);
        float t = xv.x * wv[0];
        t = fmaf(xv.y, wv[1], t);
        t = fmaf(xv.z, wv[2], t);
        t = fmaf(xv.w, wv[3], t);
        acc[b] = fmaf(t, sc, acc[b]);
      }
      if constexpr (!B128) {
        sp += gr.q;
        rem += gr.r;
        if (rem >= gr.b1) {
          rem -= gr.b1;
          ++sp;
        }
      }
    }
  }
}

// x (NB <= 4 rows, n) in dtype XK against W (d, n) e5m2 with f32 scales s
// (ceil(d/b0), ceil(n/b1)) -> y (NB, d) f32. Warp i takes rows i, i +
// warps, ...; a step is kWords words a lane of one row (1024 columns).
template <int XK, int NB, bool B128>
__global__ void __launch_bounds__(kThreads, NB <= 2 ? kBlocksFew : kBlocksMany)
fp8_mv_kernel(const void* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ s, float* __restrict__ y, int d, int n, Fp8Grid gr) {
  constexpr int kX = XK == 0 ? 4 : 2;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const int nw = n >> 2, span = 32 * kWords;     // words a row, words a step
  int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), j0 = 0;
  if (r >= d) return;
  // the step after (rr, jj): the rest of row rr, or the next row's first
  auto next = [&](int& rr, int& jj) {
    jj += span;
    if (jj >= nw) {
      rr += warps;
      jj = 0;
    }
  };
  auto load = [&](uint32_t (&dst)[kWords], int rr, int jj) {
    const uint8_t* wl = w + (size_t)rr * n + 4 * (jj + lane);
    const int live = words_live(jj, nw);
    if (live == kWords) load_words(dst, wl, kWords);
    else load_words(dst, wl, live);
  };
  const float* sr = s + (size_t)(r / gr.b0) * gr.g1;   // the row block's scales
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  // one step over the words in cur, the next step's words loaded into nxt
  // first; false after the warp's last step. The two buffers swap roles
  // from step to step (a register copy would wait for the load).
  auto step = [&](uint32_t (&cur)[kWords], uint32_t (&nxt)[kWords]) {
    int r1 = r, j1 = j0;
    next(r1, j1);
    if (r1 < d) load(nxt, r1, j1);
    const int c = 4 * (j0 + lane);
    const char* xl = static_cast<const char*>(x) + (size_t)c * kX;
    const int live = words_live(j0, nw);
    if (live == kWords) fp8_step<XK, NB, B128>(acc, cur, xl, n, c, sr, gr, kWords);
    else fp8_step<XK, NB, B128>(acc, cur, xl, n, c, sr, gr, live);
    if (j1 == 0) {                               // the row is done
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], m);
        if (lane == b) y[(size_t)b * d + r] = acc[b];
        acc[b] = 0.f;
      }
    }
    if (r1 >= d) return false;
    if (r1 != r) sr = s + (size_t)(r1 / gr.b0) * gr.g1;
    r = r1;
    j0 = j1;
    return true;
  };
  uint32_t ua[kWords], ub[kWords];
  load(ua, r, j0);
  while (step(ua, ub) && step(ub, ua)) {
  }
}

template <int XK, int NB, bool B128>
cudaError_t launch(const void* x, const uint8_t* w, const float* s, float* y, int d, int n,
                   const Fp8Grid& gr, cudaStream_t st) {
  static int most = 0;                           // warps the card holds at the launch bounds
  if (most == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fp8_mv_kernel<XK, NB, B128>,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    most = max(1, per_sm) * sms * (kThreads / 32);
  }
  // every warp walks per or per - 1 rows
  const int per = (d + most - 1) / most, warps = (d + per - 1) / per;
  fp8_mv_kernel<XK, NB, B128><<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                                 st>>>(x, w, s, y, d, n, gr);
  return cudaGetLastError();
}

template <int XK, bool B128>
cudaError_t dispatch(const void* x, const uint8_t* w, const float* s, float* y, int rows,
                     int d, int n, const Fp8Grid& gr, cudaStream_t st) {
  switch (rows) {
    case 1: return launch<XK, 1, B128>(x, w, s, y, d, n, gr, st);
    case 2: return launch<XK, 2, B128>(x, w, s, y, d, n, gr, st);
    case 3: return launch<XK, 3, B128>(x, w, s, y, d, n, gr, st);
    case 4: return launch<XK, 4, B128>(x, w, s, y, d, n, gr, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool B128>
cudaError_t dispatch_x(const void* x, int xk, const uint8_t* w, const float* s, float* y,
                       int rows, int d, int n, const Fp8Grid& gr, cudaStream_t st) {
  if (xk == 0) return dispatch<0, B128>(x, w, s, y, rows, d, n, gr, st);
  if (xk == 1) return dispatch<1, B128>(x, w, s, y, rows, d, n, gr, st);
  return dispatch<2, B128>(x, w, s, y, rows, d, n, gr, st);
}

}  // namespace

// y (rows, d) f32 = x (rows, n) in dtype x_dtype (0 f32, 1 f16, 2 bf16)
// against the F8E5M2 weight W (d, n) with f32 inverse scales s (ceil(d/b0),
// ceil(n/b1)), kMvRowsX x rows a pass (each pass reads the weight once).
// Needs n % 16 == 0, b1 % 16 == 0, a 16-byte aligned W and x. Returns a
// cudaError_t; the launches are asynchronous on `stream`.
extern "C" int fp8_mv(const void* x, int x_dtype, const void* w, const void* s, void* y,
                      int rows, int d, int n, int b0, int b1, void* stream) {
  if (rows <= 0 || d <= 0 || n <= 0 || n % 16 != 0 || b0 <= 0 || b1 <= 0 || b1 % 16 != 0 ||
      x_dtype < 0 || x_dtype > 2 || x == nullptr || w == nullptr || s == nullptr ||
      y == nullptr)
    return (int)cudaErrorInvalidValue;
  const Fp8Grid gr{b0, b1, (n + b1 - 1) / b1, 128 / b1, 128 % b1};
  const size_t xsz = x_dtype == 0 ? 4 : 2;
  const auto wp = static_cast<const uint8_t*>(w);
  const auto sp = static_cast<const float*>(s);
  auto st = static_cast<cudaStream_t>(stream);
  for (int r0 = 0; r0 < rows; r0 += kMvRowsX) {
    const void* xp = static_cast<const char*>(x) + (size_t)r0 * n * xsz;
    float* yp = static_cast<float*>(y) + (size_t)r0 * d;
    const int rr = min(kMvRowsX, rows - r0);
    const cudaError_t err =
        b1 == 128 ? dispatch_x<true>(xp, x_dtype, wp, sp, yp, rr, d, n, gr, st)
                  : dispatch_x<false>(xp, x_dtype, wp, sp, yp, rr, d, n, gr, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
