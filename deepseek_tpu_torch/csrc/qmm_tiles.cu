// Tile GEMM for many activation rows against quantized weights, on Hopper
// (sm_90a). One kernel family, templated on the weight reader:
//
//   K1 row-tiled: deepseek_tpu/ops/pallas/qmm.py::qmm with _knib_body at
//       many rows (a prefill chunk's projections, wkv_b over the window);
//   K6: ::qmm_grouped with _knib_body: 128-row tiles, tile g against
//       expert tile_expert[g] of a nibble table (E, d, n);
//   K5 row-tiled and K6 with the fp8 body (qmm.py:418 and :502-508,
//       _fp8_body :260): the same routes over a blockwise F8E5M2 weight;
//   K5 row-tiled and K6 with the packed bodies (qmm.py:361/:368 _q2k_body
//       and _q3k_body, rows tiled by 128 :347-351; qmm_grouped :471-478,
//       launched :538): the same routes over packed Q2_K/Q3_K planes;
//   K5 row-tiled and K6 with the turbo bodies (qmm.py:378/:385 _q2kt_body
//       and _q3kt_body; qmm_grouped :479-487, launched :538): the same
//       routes over the int8 turbo planes.
// (K11, rows grouped against a plain table, is csrc/gmm.cu, on the
// tensor cores.)
//
//   y[row, r] = sum_c x[row, c] * W[e(row)][r, c]     (f32 accumulation)
//
// A block owns one tile of at most 128 consecutive activation rows, all of
// one expert, and 128 output columns (weight rows); the grid is (tiles,
// column blocks), tiles fastest, so the blocks that share a weight block
// run together and it is read from device memory about once.
//  - K1: tile g = rows 128g.., expert 0;
//  - K6: tile g = rows 128g.. of the (G, 128, n) tiles, expert
//    tile_expert[g], and only the first tile_rows[g] rows when given (the
//    rest of the tile is left unwritten: the caller never reads it).
//
// Bound: at 128 rows a tile does 256 flops per weight it reads, above the
// card's balance point even in bf16, so the products bound it. This first
// version computes them with float32 FMAs on the CUDA cores: each k-step
// stages a 128 x 64 activation block and a 64 x 128 weight block in shared
// memory as float32, and a thread owns an 8 x 8 register tile. The next
// step's global loads start before this step's products, so their
// latency hides behind them. A K6 tile under a real routing often has a
// handful of live rows (256 experts, ~9 pairs a token): a tile of at most
// 16 live rows gives every thread 8 rows x 1 column instead, so all eight
// warps share its products, and the weight block's read bounds it.
// The quantized weights dequantize to f32 values, so tensor cores would
// need two or three bf16 terms a weight (csrc/gmm.cu's split); that is
// later work (ROADMAP.md).
//
// Nibble reader. In the stride-16 permuted plane, byte o*n16 + g (o < 8)
// holds natural column 16g + o in its low nibble and 16g + 8 + o in its
// high nibble, so the 64 natural columns of groups g0..g0+3 are 8 aligned
// 4-byte words (o = 0..7) per weight row, each in its own 32-byte sector.
// Loading them a step at a time costs a sector per word, so the reader
// stages 512 columns at once: per weight row 8 slabs of 32 contiguous
// bytes (and the 32 scales), in 16-byte loads started a whole stage ahead.
// Each step then dequantizes its 64 columns from that raw copy into
// natural order in shared memory, a * (u - off) - c, the f32 arithmetic of
// the plain version (quant/qtensor.py). The activations then stay in their
// natural order: unlike the one-row matvec (csrc/qmm.cu), a tile shares each
// dequantized weight among 128 rows, so it needs neither the permuted
// activation copy nor the per-16 group sums the TPU kernel took from HBM.
//
// K6's prepermuted nibble body (kinds 10 and 11; the rp branch of
// deepseek_tpu/ops/matmul.py:268-285, qmm_grouped with group sums over the
// permuted layout): behind a row-permuted w13 table h arrives in the
// stride-16 permuted order. A k-step's natural columns 16(g0+q) + o (q < 4,
// o < 16) sit at permuted positions o*n16 + g0 + q, so the step loads one
// aligned float4 at each of the 16 offsets o*n16 + g0 of an activation row
// and writes its 4 values to natural columns 16q + o of the staged block:
// the same 16-byte loads, no copy of the activations, the same products.
//
// Packed reader (Q2_K, Q3_K). The 64 natural columns of groups g0..g0+3
// are one 4-byte word at each of the 4 offsets jq*n16 + g0 of the 2-bit
// plane qs (field s of byte jq*n16 + g = offset 4s + jq of group g) and,
// for Q3_K, at the 2 offsets jh*n16 + g0 of the 1-bit plane hm (bit b of
// byte jh*n16 + g = offset 2b + jh; see csrc/qmm.cu). As the nibble reader,
// the reader stages 512 columns at once: per weight row 4 qs slabs and 2
// hm slabs of 32 contiguous bytes and the 32 scale bytes (sm | mn << 4, or
// Q3_K's signed sc), in 16-byte loads started a whole stage ahead, and
// each thread keeps its row's two f32 super scales (and Q2_K's super mins)
// of the stage in registers. A step then writes the f32 dequantization of
// the plain version (Q2KTensor / Q3KTensor.dequant) in natural order:
//   Q2_K: (d*sc) * q - dmin*mn;  Q3_K: (d*sc) * (qlow + 4*hbit - 4).
//
// Turbo readers. Q2_K turbo's plane is int8 in natural order, so a
// k-step's 64 bytes of a weight row load as the fp8 reader's below, each
// 16-byte vector with its row's f32 super scale d[r][k0/256] and the bf16
// min term bm[r][g] of its group (a vector is one group): w = d*p - bm.
// Q3_K turbo's plane is int8 in the permuted order: the 64 natural columns
// of groups g0..g0+3 are one 4-byte word at each of the 16 offsets
// o*n16 + g0. As the nibble reader, the reader stages a raw copy, here
// 256 columns (per weight row 16 slabs of 16 contiguous bytes and the 16
// bf16 scales a), a whole stage ahead, and each step writes a[g] * p in
// natural order: the f32 dequantization of the plain version
// (Q2KTurboTensor / Q3KTurboTensor.dequant). Bound: bytes at few live rows,
// 1 byte a weight, as the other readers.
//
// F8E5M2 reader. A k-step's 64 bytes of a weight row are four 16-byte
// vectors; two neighbouring lanes load one whole 32-byte sector, and each
// lane takes its row's f32 block scale s[r / b0][k0 / b1] with it. The
// step widens the bytes exactly to f32 (fp8.cuh) and stores weight x scale
// in shared memory, the f32 dequantization of the plain version
// (Fp8Tensor.dequant). A 64-column step never straddles a scale block
// (b1 % 64 == 0: the converter's 128), and a partial edge block (a 576-row
// or 10944-column weight) is a row or column index like any other, so the
// grid needs no padding.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fp8.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBM = 128;          // activation rows per tile
constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 64;           // reduction columns per step (4 groups)
constexpr int kLdx = kBM + 4;     // xs[k][m] row stride (16-byte rows)
constexpr int kLdw = kBN + 4;     // ws[k][r] row stride
constexpr int kSW = 512;          // nibble columns staged raw at a time
constexpr int kLdp = 8 * 8 + 1;   // praw row: 8 slabs x 8 words (+1: banks)
constexpr int kLda = 16 + 1;      // araw/craw row: 32 bf16 scales (+1)
constexpr int kSmemBytes = (kBK * kLdx + kBK * kLdw) * sizeof(float);
constexpr int kSmemNib = kSmemBytes + (kBN * kLdp + 2 * kBN * kLda) * 4;

// kinds 2-4 were the plain tables, now K11's own kernel (csrc/gmm.cu)
enum Kind { kNib = 0, kNibC = 1, kF8 = 5, kQ2 = 6, kQ3 = 7, kQ2T = 8, kQ3T = 9,
            kNibP = 10, kNibCP = 11 };
constexpr int kSW3T = 256;        // Q3_K turbo columns staged raw at a time

struct Weights {
  const void* w;          // nibble plane p (E, d, n/2) u8,
                          // F8E5M2 bytes (E, d, n), packed qs (E, d, n/4)
                          // or turbo plane p (E, d, n) int8
  const uint16_t* a;      // nibble scales, turbo bm (Q2_K) or a (Q3_K):
                          // (E, d, n/16) bf16
  const uint16_t* c;      // nibble min terms (E, d, n/16) bf16, or null
  float off;
  const float* s;         // fp8 inverse scales (E, ceil(d/b0), ceil(n/b1)),
                          // or packed / Q2_K turbo super scales d (E, d, n/256)
  int b0, b1;             // fp8 scale block
  const uint8_t* s8;      // packed scale bytes (E, d, n/16): sm or sc
  const uint8_t* hm;      // Q3_K high-bit plane (E, d, n/8)
  const float* dmin;      // Q2_K super mins (E, d, n/256)
};

struct Tiles {
  const int32_t* tile_expert;   // (G,) or null: expert 0
  const int32_t* tile_rows;     // (G,) live rows per tile, or null
  int rows;
};

__device__ __forceinline__ float bf16_f(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// tile g -> (expert, first row, live rows); false for a tile with no rows
__device__ bool tile_of(const Tiles& t, int g, int& e, int& r0, int& nr) {
  e = t.tile_expert != nullptr ? t.tile_expert[g] : 0;
  r0 = g * kBM;
  nr = min(kBM, t.rows - r0);
  if (t.tile_rows != nullptr) nr = min(nr, t.tile_rows[g]);
  return nr > 0;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
tile_gemm_kernel(const float* __restrict__ x, Weights wt, Tiles tl,
                 float* __restrict__ y, int d, int n) {
  constexpr bool kHasC = KIND == kNibC || KIND == kNibCP;   // nibble min plane
  constexpr bool kXPerm = KIND == kNibP || KIND == kNibCP;  // x in permuted order
  constexpr bool kNibble = KIND == kNib || kHasC || kXPerm;
  constexpr bool kPacked = KIND == kQ2 || KIND == kQ3;
  constexpr bool kStaged = kNibble || kPacked || KIND == kQ3T;  // raw planes staged
  constexpr int kStageW = KIND == kQ3T ? kSW3T : kSW;           // columns a stage
  constexpr bool kFp8 = KIND == kF8;
  constexpr bool kBytes = kFp8 || KIND == kQ2T;    // 1-byte weights, natural order
  constexpr int kXIt = kBM * kBK / 4 / kThreads;   // 8 activation items
  constexpr int kOIt = kBN * 8 / kThreads;         // 4 nibble words
  constexpr int kFIt = kBN * kBK / 16 / kThreads;  // 2 fp8 16-byte vectors

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kBK][kLdx]
  float* ws = xs + kBK * kLdx;                   // [kBK][kLdw]
  // nibble: the raw planes of kSW columns for the block's kBN rows
  // (packed: the 4 qs slabs in praw, the scale bytes in araw, the 2 hm
  // slabs in craw)
  uint32_t* praw = reinterpret_cast<uint32_t*>(ws + kBK * kLdw);  // [kBN][kLdp]
  uint32_t* araw = praw + kBN * kLdp;                              // [kBN][kLda]
  uint32_t* craw = araw + kBN * kLda;                              // [kBN][kLda]

  int e, r0, nr;
  if (!tile_of(tl, blockIdx.x, e, r0, nr)) return;
  const int col0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 15, ty = warp * 2 + (lane >> 4);
  // a tile of at most 16 live rows spreads them over every warp (narrow:
  // thread = 8 rows x 1 column); a wider one takes the 8 x 8 register
  // tiles (rows 8ty.., columns 4tx.. and 64+4tx..), and a warp whose 16
  // rows are all dead skips the products
  const bool narrow = nr <= 16;
  const bool warp_live = warp * 16 < nr;

  const int n16 = n >> 4;
  const size_t half = (size_t)(n >> 1);
  const uint8_t* pe = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * half;
  const uint16_t* ae = wt.a + (size_t)e * d * n16;
  const uint16_t* ce = kHasC ? wt.c + (size_t)e * d * n16 : nullptr;
  const int wr_r = tid & (kBN - 1), wr_o = tid / kBN;   // nibble: row, byte slab
  const uint8_t* w8 = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * n;
  const int g0 = kFp8 ? (d + wt.b0 - 1) / wt.b0 : 0;
  const int g1 = kFp8 ? (n + wt.b1 - 1) / wt.b1 : 0;
  const float* se = kFp8 ? wt.s + (size_t)e * g0 * g1 : nullptr;
  // packed planes of expert e
  const size_t n4 = (size_t)(n >> 2), n8 = (size_t)(n >> 3), n256 = (size_t)(n >> 8);
  const uint8_t* qe = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * n4;
  const uint8_t* he = KIND == kQ3 ? wt.hm + (size_t)e * d * n8 : nullptr;
  const uint8_t* s8e = kPacked ? wt.s8 + (size_t)e * d * n16 : nullptr;
  const float* dse = kPacked || KIND == kQ2T ? wt.s + (size_t)e * d * n256 : nullptr;
  const float* dme = KIND == kQ2 ? wt.dmin + (size_t)e * d * n256 : nullptr;

  float4 xr[kXIt];
  uint4 fr[kFIt];                    // fp8, Q2_K turbo: a step's raw vectors
  float fs[kFIt];                    // and their rows' block (super) scales
  float fb[kFIt];                    // Q2_K turbo: and their groups' min terms
  uint4 pr[8], ar[2], cr[2];         // nibble: one raw stage in flight
  uint4 qr[4], hr[2], sr;            // packed: one raw stage in flight
  float sup_next[2], min_next[2];    // packed: the row's super scales and
  float sup_cur[2], min_cur[2];      // mins of the next and this stage

  // nibble: start the coalesced 16-byte loads of the raw stage at column
  // ks: per weight row 8 slabs x 32 bytes (groups ks/16 .. +31) and the
  // 32 scales (and min terms); a 256-column tail stage loads half
  auto load_raw = [&](int ks) {
    const int gs = ks >> 4, sg = min(kSW, n - ks) >> 4;   // stage groups
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int item = tid + it * kThreads;
      const int ch = item & 1, o = (item >> 1) & 7, r = item >> 4;
      const size_t gr = (size_t)min(col0 + r, d - 1);
      if (ch * 16 < sg)
        pr[it] = *reinterpret_cast<const uint4*>(
            pe + gr * half + (size_t)o * n16 + gs + ch * 16);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int item = tid + it * kThreads;
      const int q = item & 3, r = item >> 2;
      const size_t gr = (size_t)min(col0 + r, d - 1);
      if (q * 8 < sg) {
        ar[it] = *reinterpret_cast<const uint4*>(ae + gr * n16 + gs + q * 8);
        if constexpr (kHasC)
          cr[it] = *reinterpret_cast<const uint4*>(ce + gr * n16 + gs + q * 8);
      }
    }
  };
  auto store_raw = [&](int ks) {
    const int sg = min(kSW, n - ks) >> 4;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int item = tid + it * kThreads;
      const int ch = item & 1, o = (item >> 1) & 7, r = item >> 4;
      if (ch * 16 >= sg) continue;
      uint32_t* dst = praw + r * kLdp + o * 8 + ch * 4;
      dst[0] = pr[it].x; dst[1] = pr[it].y; dst[2] = pr[it].z; dst[3] = pr[it].w;
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int item = tid + it * kThreads;
      const int q = item & 3, r = item >> 2;
      if (q * 8 >= sg) continue;
      uint32_t* da = araw + r * kLda + q * 4;
      da[0] = ar[it].x; da[1] = ar[it].y; da[2] = ar[it].z; da[3] = ar[it].w;
      if constexpr (kHasC) {
        uint32_t* dc = craw + r * kLda + q * 4;
        dc[0] = cr[it].x; dc[1] = cr[it].y; dc[2] = cr[it].z; dc[3] = cr[it].w;
      }
    }
  };

  // packed: the coalesced 16-byte loads of the raw stage at column ks:
  // per weight row 4 qs slabs, 2 hm slabs and the scale bytes, 32 bytes
  // each (groups ks/16 .. +31; a 256-column tail stage loads half), and
  // this thread's row's super scales
  auto load_raw_packed = [&](int ks) {
    const int gs = ks >> 4, sg = min(kSW, n - ks) >> 4;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int item = tid + it * kThreads;
      const int ch = item & 1, jq = (item >> 1) & 3, r = item >> 3;
      const size_t gr = (size_t)min(col0 + r, d - 1);
      if (ch * 16 < sg)
        qr[it] = *reinterpret_cast<const uint4*>(
            qe + gr * n4 + (size_t)jq * n16 + gs + ch * 16);
    }
    if constexpr (KIND == kQ3) {
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int item = tid + it * kThreads;
        const int ch = item & 1, jh = (item >> 1) & 1, r = item >> 2;
        const size_t gr = (size_t)min(col0 + r, d - 1);
        if (ch * 16 < sg)
          hr[it] = *reinterpret_cast<const uint4*>(
              he + gr * n8 + (size_t)jh * n16 + gs + ch * 16);
      }
    }
    {
      const int ch = tid & 1, r = tid >> 1;
      const size_t gr = (size_t)min(col0 + r, d - 1);
      if (ch * 16 < sg)
        sr = *reinterpret_cast<const uint4*>(s8e + gr * n16 + gs + ch * 16);
    }
    const size_t gr = (size_t)min(col0 + wr_r, d - 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j * 16 < sg) {
        sup_next[j] = dse[gr * n256 + (ks >> 8) + j];
        if constexpr (KIND == kQ2) min_next[j] = dme[gr * n256 + (ks >> 8) + j];
      }
    }
  };
  auto store_raw_packed = [&](int ks) {
    const int sg = min(kSW, n - ks) >> 4;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int item = tid + it * kThreads;
      const int ch = item & 1, jq = (item >> 1) & 3, r = item >> 3;
      if (ch * 16 >= sg) continue;
      uint32_t* dst = praw + r * kLdp + jq * 8 + ch * 4;
      dst[0] = qr[it].x; dst[1] = qr[it].y; dst[2] = qr[it].z; dst[3] = qr[it].w;
    }
    if constexpr (KIND == kQ3) {
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int item = tid + it * kThreads;
        const int ch = item & 1, jh = (item >> 1) & 1, r = item >> 2;
        if (ch * 16 >= sg) continue;
        uint32_t* dst = craw + r * kLda + jh * 8 + ch * 4;
        dst[0] = hr[it].x; dst[1] = hr[it].y; dst[2] = hr[it].z; dst[3] = hr[it].w;
      }
    }
    {
      const int ch = tid & 1, r = tid >> 1;
      if (ch * 16 < sg) {
        uint32_t* dst = araw + r * kLda + ch * 4;
        dst[0] = sr.x; dst[1] = sr.y; dst[2] = sr.z; dst[3] = sr.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sup_cur[j] = sup_next[j];
      min_cur[j] = min_next[j];
    }
  };

  // Q3_K turbo: the 16-byte loads of the raw stage at column ks: per
  // weight row the 16 slabs o*n16 + ks/16 (16 groups each) and the 16
  // scales
  auto load_raw_q3t = [&](int ks) {
    const int gs = ks >> 4;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int item = tid + it * kThreads;
      const int o = item & 15, r = item >> 4;
      const size_t gr = (size_t)min(col0 + r, d - 1);
      pr[it] = *reinterpret_cast<const uint4*>(w8 + gr * n + (size_t)o * n16 + gs);
    }
    const int ch = tid & 1, r = tid >> 1;
    const size_t gr = (size_t)min(col0 + r, d - 1);
    ar[0] = *reinterpret_cast<const uint4*>(ae + gr * n16 + gs + ch * 8);
  };
  auto store_raw_q3t = [&]() {
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int item = tid + it * kThreads;
      const int o = item & 15, r = item >> 4;
      uint32_t* dst = praw + r * kLdp + o * 4;
      dst[0] = pr[it].x; dst[1] = pr[it].y; dst[2] = pr[it].z; dst[3] = pr[it].w;
    }
    const int ch = tid & 1, r = tid >> 1;
    uint32_t* da = araw + r * kLda + ch * 4;
    da[0] = ar[0].x; da[1] = ar[0].y; da[2] = ar[0].z; da[3] = ar[0].w;
  };

  // start one k-step's global loads (clamped rows, dead activation rows
  // skipped); they stay in flight while the previous step computes
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kXIt; ++it) {
      const int item = tid + it * kThreads;
      const int m = item & (kBM - 1), c4 = (item / kBM) * 4;
      // permuted x: c4 / 4 is the offset o, the float4 groups k0/16 .. +3
      const int col = kXPerm ? (c4 >> 2) * n16 + (k0 >> 4) : k0 + c4;
      if (m < nr)
        xr[it] = *reinterpret_cast<const float4*>(x + (size_t)(r0 + m) * n + col);
    }
    if constexpr (kBytes) {
#pragma unroll
      for (int it = 0; it < kFIt; ++it) {
        const int item = tid + it * kThreads;
        const int r = (item >> 1) & (kBN - 1);
        const int c16 = ((item >> 8) * 2 + (item & 1)) * 16;
        const int gr = min(col0 + r, d - 1);
        fr[it] = *reinterpret_cast<const uint4*>(w8 + (size_t)gr * n + k0 + c16);
        if constexpr (kFp8) {
          fs[it] = se[(size_t)(gr / wt.b0) * g1 + k0 / wt.b1];
        } else {
          fs[it] = dse[(size_t)gr * n256 + (k0 >> 8)];
          fb[it] = bf16_f(ae[(size_t)gr * n16 + ((k0 + c16) >> 4)]);
        }
      }
    }
  };

  // registers -> shared memory as f32, both k-major (a warp's 32 lanes
  // hold 32 consecutive rows, so the stores hit distinct banks); the
  // weights in natural column order
  auto store = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kXIt; ++it) {
      const int item = tid + it * kThreads;
      const int m = item & (kBM - 1), c4 = (item / kBM) * 4;
      if (m >= nr) continue;
      const float v[4] = {xr[it].x, xr[it].y, xr[it].z, xr[it].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xs[(kXPerm ? q * 16 + (c4 >> 2) : c4 + q) * kLdx + m] = v[q];
    }
    if constexpr (kNibble) {
      // the 4 groups of this step sit in word `w` of each slab of the stage
      const int w = (k0 % kSW) / kBK;
      const uint32_t a01 = araw[wr_r * kLda + 2 * w];
      const uint32_t a23 = araw[wr_r * kLda + 2 * w + 1];
      const float af[4] = {bf16_f(a01 & 0xFFFFu), bf16_f(a01 >> 16),
                           bf16_f(a23 & 0xFFFFu), bf16_f(a23 >> 16)};
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kHasC) {
        const uint32_t c01 = craw[wr_r * kLda + 2 * w];
        const uint32_t c23 = craw[wr_r * kLda + 2 * w + 1];
        cf[0] = bf16_f(c01 & 0xFFFFu); cf[1] = bf16_f(c01 >> 16);
        cf[2] = bf16_f(c23 & 0xFFFFu); cf[3] = bf16_f(c23 >> 16);
      }
#pragma unroll
      for (int it = 0; it < kOIt; ++it) {
        const int o = wr_o + 2 * it;
        const uint32_t wb = praw[wr_r * kLdp + o * 8 + w];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float lo = (float)((wb >> (8 * q)) & 0xFu);
          const float hi = (float)((wb >> (8 * q + 4)) & 0xFu);
          ws[(q * 16 + o) * kLdw + wr_r] = af[q] * (lo - wt.off) - cf[q];
          ws[(q * 16 + 8 + o) * kLdw + wr_r] = af[q] * (hi - wt.off) - cf[q];
        }
      }
    } else if constexpr (kPacked) {
      // the 4 groups of this step: word `w` of each slab, byte k = group k;
      // this thread's row wr_r and the offsets of slabs jq = wr_o, wr_o + 2
      const int w = (k0 % kSW) / kBK;
      const int sb = (k0 % kSW) >> 8;                // superblock in the stage
      const uint32_t sw = araw[wr_r * kLda + w];
      float scale[4], minv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t b = (sw >> (8 * k)) & 0xFFu;
        if constexpr (KIND == kQ2) {
          scale[k] = sup_cur[sb] * (float)(b & 0xFu);
          minv[k] = min_cur[sb] * (float)(b >> 4);
        } else {
          scale[k] = sup_cur[sb] * (float)(int8_t)b;
        }
      }
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int jq = wr_o + 2 * it;
        const uint32_t qw = praw[wr_r * kLdp + jq * 8 + w];
        const uint32_t hw = KIND == kQ3 ? craw[wr_r * kLda + (jq & 1) * 8 + w] : 0u;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int o = 4 * s + jq;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = (int)((qw >> (8 * k + 2 * s)) & 3u);
            float v;
            if constexpr (KIND == kQ2) {
              v = scale[k] * (float)q - minv[k];
            } else {
              const int h = (int)((hw >> (8 * k + 2 * s + (jq >> 1))) & 1u);
              v = scale[k] * (float)(q + 4 * h - 4);
            }
            ws[(k * 16 + o) * kLdw + wr_r] = v;
          }
        }
      }
    } else if constexpr (KIND == kQ3T) {
      // the 4 groups of this step: word `w` of each of the 16 slabs, byte
      // k = group k; this thread's row wr_r and offsets o = wr_o + 2*it
      const int w = (k0 % kSW3T) / kBK;
      const uint32_t a01 = araw[wr_r * kLda + 2 * w];
      const uint32_t a23 = araw[wr_r * kLda + 2 * w + 1];
      const float af[4] = {bf16_f(a01 & 0xFFFFu), bf16_f(a01 >> 16),
                           bf16_f(a23 & 0xFFFFu), bf16_f(a23 >> 16)};
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int o = wr_o + 2 * it;
        const uint32_t wb = praw[wr_r * kLdp + o * 4 + w];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ws[(q * 16 + o) * kLdw + wr_r] = af[q] * (float)(int8_t)(wb >> (8 * q));
      }
    } else {
      static_assert(kBytes, "a weight reader for every kind");
#pragma unroll
      for (int it = 0; it < kFIt; ++it) {
        const int item = tid + it * kThreads;
        const int r = (item >> 1) & (kBN - 1);
        const int c16 = ((item >> 8) * 2 + (item & 1)) * 16;
        float v[16];
        if constexpr (kFp8) {
          e5m2x16(fr[it], v);
#pragma unroll
          for (int q = 0; q < 16; ++q) v[q] *= fs[it];
        } else {
          const uint32_t u[4] = {fr[it].x, fr[it].y, fr[it].z, fr[it].w};
#pragma unroll
          for (int q = 0; q < 16; ++q)
            v[q] = fs[it] * (float)(int8_t)(u[q >> 2] >> (8 * (q & 3))) - fb[it];
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) ws[(c16 + q) * kLdw + r] = v[q];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int rg = tid & 1, nc = tid >> 1;     // narrow: rows 8rg.., column nc

  load(0);
  if constexpr (kNibble) load_raw(0);
  if constexpr (kPacked) load_raw_packed(0);
  if constexpr (KIND == kQ3T) load_raw_q3t(0);
  for (int k0 = 0; k0 < n; k0 += kBK) {
    __syncthreads();                 // the previous step's blocks consumed
    if constexpr (kStaged) {
      if (k0 % kStageW == 0) {       // a new raw stage: store it, fetch the next
        if constexpr (kNibble) store_raw(k0);
        else if constexpr (kPacked) store_raw_packed(k0);
        else store_raw_q3t();
        __syncthreads();
        if (k0 + kStageW < n) {
          if constexpr (kNibble) load_raw(k0 + kStageW);
          else if constexpr (kPacked) load_raw_packed(k0 + kStageW);
          else load_raw_q3t(k0 + kStageW);
        }
      }
    }
    store(k0);
    __syncthreads();
    if (k0 + kBK < n) load(k0 + kBK);
    if (narrow) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float w = ws[k * kLdw + nc];
        const float4 xa = *reinterpret_cast<const float4*>(xs + k * kLdx + rg * 8);
        const float4 xb = *reinterpret_cast<const float4*>(xs + k * kLdx + rg * 8 + 4);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[0][i] = fmaf(xv[i], w, acc[0][i]);
      }
    } else if (warp_live) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float* xk = xs + k * kLdx + ty * 8;
        const float* wk = ws + k * kLdw + tx * 4;
        const float4 xa = *reinterpret_cast<const float4*>(xk);
        const float4 xb = *reinterpret_cast<const float4*>(xk + 4);
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wc = *reinterpret_cast<const float4*>(wk + 64);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
  }

  if (narrow) {
    const int col = col0 + nc;
    if (col >= d) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = rg * 8 + i;
      if (m < nr) y[(size_t)(r0 + m) * d + col] = acc[0][i];
    }
    return;
  }
  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty * 8 + i;
    if (m >= nr) continue;
    float* yr = y + (size_t)(r0 + m) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j & 4) * 16 + tx * 4 + (j & 3);
      if (col < d) yr[col] = acc[i][j];
    }
  }
}

template <int KIND>
cudaError_t launch(const float* x, const Weights& wt, const Tiles& tl,
                   float* y, int G, int d, int n, cudaStream_t stream) {
  constexpr int smem = KIND == kF8 || KIND == kQ2T ? kSmemBytes : kSmemNib;
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_gemm_kernel<KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  dim3 grid(G, (d + kBN - 1) / kBN);
  tile_gemm_kernel<KIND><<<grid, kThreads, smem, stream>>>(x, wt, tl, y, d, n);
  return cudaGetLastError();
}

}  // namespace

// y (rows, d) f32 = tile GEMM of x (rows, n) f32 against W (E, d, n).
// kind: 0/1 = nibble without/with the min plane c (w = p, a, c, off), 5 =
// F8E5M2 table (w) with the f32 inverse scales s (E, ceil(d/b0),
// ceil(n/b1)), 6 = packed Q2_K (w = qs, a = sm, s = d, s2 = dmin), 7 =
// packed Q3_K (w = qs, a = sc, c = hm, s = d), 8 = Q2_K turbo (w = p, a =
// bm, s = d), 9 = Q3_K turbo (w = p, a), 10/11 = nibble as 0/1 with x in
// the stride-16 permuted order. Tiles as the header says: tile_expert and
// tile_rows (G,) or null. Needs n % 64 == 0 (nibble, packed and turbo: n %
// 256 == 0; fp8: b1 % 64 == 0), G <= 2^31 - 1, d <= 8388480. Returns a
// cudaError_t; the launch is asynchronous on `stream`.
extern "C" int tile_gemm(const void* x, int kind, const void* w,
                         const void* a, const void* c, int off,
                         const void* s, int b0, int b1, const void* s2,
                         const void* tile_expert, const void* tile_rows,
                         void* y, int rows, int G, int d, int n,
                         void* stream) {
  const bool kq = kind != kF8;
  if (rows <= 0 || G <= 0 || d <= 0 || d > 65535 * kBN || n <= 0 ||
      n % (kq ? 256 : kBK) != 0 || kind < kNib || kind > kNibCP ||
      (kind > kNibC && kind < kF8) ||
      w == nullptr || ((kind == kNibC || kind == kNibCP) && c == nullptr) ||
      (kind == kF8 && (s == nullptr || b0 <= 0 || b1 <= 0 || b1 % kBK != 0)) ||
      ((kind == kQ2 || kind == kQ3) && (a == nullptr || s == nullptr)) ||
      (kind == kQ2 && s2 == nullptr) || (kind == kQ3 && c == nullptr) ||
      ((kind == kQ2T || kind == kQ3T) && a == nullptr) ||
      (kind == kQ2T && s == nullptr))
    return (int)cudaErrorInvalidValue;
  Weights wt{w, static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(c),
             (float)off, static_cast<const float*>(s), b0, b1,
             static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(c),
             static_cast<const float*>(s2)};
  Tiles tl{static_cast<const int32_t*>(tile_expert),
           static_cast<const int32_t*>(tile_rows), rows};
  auto xs = static_cast<const float*>(x);
  auto ys = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kNib: err = launch<kNib>(xs, wt, tl, ys, G, d, n, st); break;
    case kNibC: err = launch<kNibC>(xs, wt, tl, ys, G, d, n, st); break;
    case kNibP: err = launch<kNibP>(xs, wt, tl, ys, G, d, n, st); break;
    case kNibCP: err = launch<kNibCP>(xs, wt, tl, ys, G, d, n, st); break;
    case kF8: err = launch<kF8>(xs, wt, tl, ys, G, d, n, st); break;
    case kQ2: err = launch<kQ2>(xs, wt, tl, ys, G, d, n, st); break;
    case kQ3: err = launch<kQ3>(xs, wt, tl, ys, G, d, n, st); break;
    case kQ2T: err = launch<kQ2T>(xs, wt, tl, ys, G, d, n, st); break;
    default: err = launch<kQ3T>(xs, wt, tl, ys, G, d, n, st); break;
  }
  return (int)err;
}
