// Tile GEMM for many activation rows against quantized weights, on
// Hopper's tensor cores (sm_90a). One kernel family, templated on the
// weight reader:
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
// (K11, rows grouped against a plain table, is csrc/gmm.cu.)
//
//   y[row, r] = sum_c x[row, c] * dequant(W[e(row)])[r, c]   (f32 accumulation)
//
// dequant is the plain version's f32 arithmetic (quant/qtensor.py). A
// block owns 128 weight rows (output columns) and one tile of at most 128
// consecutive activation rows, all of one expert; the grid is (tiles,
// column blocks), tiles fastest, so the blocks that share a weight block
// run together and it is read from device memory about once.
//  - K1: tile g = rows 128g.., expert 0;
//  - K6: tile g = rows 128g.. of the (G, 128, n) tiles, expert
//    tile_expert[g], and only the first tile_rows[g] rows when given (the
//    rest of the tile is left unwritten: the caller never reads it). An
//    empty tile exits.
//
// Bound. A full tile does 256 flops a weight it dequantizes, above the
// card's bf16 balance point: the products bound it. A routed K6 tile (2048
// pairs over ~255 experts: ~8 live rows) does ~16: there every expert
// table is streamed and dequantized once a tile, and the readers' work a
// weight, not the products or the bytes, bounds it.
//
// Products: wgmma m64nNk16, bf16 operands, f32 accumulators. The block's
// 128 weight rows are M, two warp groups of 64 (each warp its 16); the
// tile's activation rows are N, chosen block-uniformly from the live rows
// nr (kW0..kW3: 16, 32, 64 or 128, the least >= nr), so a narrow routed
// tile does not pay for 128 rows. 128 is the widest: a 256-row chunk takes
// two tiles, each dequantizing the weight block again, since n256 would
// double the accumulators (128 registers a thread) and the activation
// tiles in shared memory, and at full tiles the products, not the
// dequantization, bound the block. Two kernels a call, each skipping the
// other's tiles (the live rows are on the card):
//  - wide tiles (more than Slot::NARROW live rows; one block an SM, up to
//    255 registers): each dequantized f32 weight split in registers into
//    bf16 hi + lo (split_rn: W - hi - lo within 2^-18 |W|), three passes a
//    k16 step, W_hi.x_hi + W_hi.x_lo + W_lo.x_hi;
//  - narrow tiles (at most 16 live rows, 32 for the byte kinds; 128
//    registers, two blocks an SM): every reader's raw value is exact in
//    one bf16 term (the nibble u, the 2-bit q, Q3_K's q + 4h - 4, the int8
//    turbo value, the e5m2 byte), so A is that value, two passes a k16
//    step (x_hi, x_lo) into a product of its own, and the scale and min
//    term of the 16-column group the k16 step covers are folded in after
//    the step's wait: y += mul * P - add * S, S the f32 sums of the x
//    rows' groups (nibble a*off + c, Q2_K dmin*mn, Q2_K turbo bm). The byte
//    kinds' scale holds a whole 64-column step: one product a step. A
//    fifth of the wide readers' work a weight; at a narrow tile the
//    readers set the pace.
// Each x becomes hi + lo, split once a k-step as it is stored in shared
// memory. A product of two bf16 values is exact in the f32 accumulators;
// the dropped W_lo.x_lo (wide) is within 2^-16 of its product. Never an
// f16, fp8 or TF32 MMA: each computes another function. The readers make
// their floats with no conversion instruction (int -> float and f32 ->
// bf16 issue at an eighth of the FMA rate on sm_90).
//
// Operand layout. A (the weights) comes from registers: each lane makes
// exactly the values of its m16n8k16 A fragment, rows g and g+8 of its
// warp's 16 (g = lane / 4) and, at k16 step kk, fragment columns 2c, 2c+1,
// 2c+8, 2c+9 (c = lane % 4): no shared-memory round trip and no ldmatrix.
// The order of the 64 columns of a k-step inside the MMA is free, as long
// as x is staged in the same order, so each reader takes the order in
// which a lane's 16 values a row sit in as few raw words as possible, and
// a k16 step covers one 16-column group (nat(kk, c, i): the natural column
// of fragment value i = 0..3 of lane c at step kk):
//  - nibble: nat = 16kk + p (the natural order): byte kk of slab 2c (2c+1)
//    holds columns 2c (2c+1) in its low and 2c+8 (2c+9) in its high nibble;
//  - packed: nat = 16kk + 4i + c: lane c reads qs slab c (field i) and hm
//    slab c & 1 (bit 2i + c/2), byte kk;
//  - Q3_K turbo: nat = 16kk + 4c + i: slabs 4c + i, byte kk;
//  - fp8, Q2_K turbo (natural byte order): nat = 16c + 4kk + i: lane c
//    reads the 16 bytes 16c.. of the step, one 16-byte chunk a row.
// B (x, hi and lo) comes from shared memory, K-major, 128-byte swizzled
// (wgmma.cuh), each row of a k-step one 128-byte line, in that order.
//
// Staging. The raw planes come into a ring of shared-memory slots by
// cp.async (16-byte copies, 4 or 8 for the per-row scales), one commit
// group a slot, refilled once its last step is done: slots of 256 columns
// (one K-quant superblock; 16-byte slab runs) for the nibble and packed
// planes (two in the ring) and Q3_K turbo's (three: at two blocks an SM
// its 1-byte plane's half-read sectors, waiting in L2 for the next slot,
// took each step 1.8x as long on the H100; three slots hold its narrow
// kernel to one block); slots of 64 columns (one k-step) for the 1-byte
// natural planes, four in the ring. A lane moves its slab words to
// registers once a slot (nibble, packed: 128-bit loads) or every two
// steps (Q3_K turbo: 64-bit loads), swizzled so that a quarter (half) warp
// meets distinct bank groups. x comes through registers a k-step ahead
// and is split into the other of two buffers while the MMAs of this step
// run. One barrier a k-step: after the step's wgmma wait and, at a slot's
// end, the next slot's cp.async wait.
//
// ptxas (-Xptxas -v, sm_90a), registers and spills a thread, narrow /
// wide kernel: nibble 119 / 199 (with c: 119 / 199; x prepermuted 123 /
// 255, with c 128 / 255), fp8 105 / 231, packed Q2_K 116 / 254, Q3_K 118 /
// 254, Q2_K turbo 126 / 230, Q3_K turbo 141 / 246; no instantiation
// spills (chip_smoke.py fails the run if one does).
//
// Readers (the f32 arithmetic of the plain versions):
//  - nibble: byte o*n16 + g of the stride-16 permuted plane holds natural
//    column 16g + o in its low nibble and 16g + 8 + o in its high one;
//    w = a * (u - off) - c;
//  - packed (Q2_K, Q3_K): field s of byte jq*n16 + g of qs = offset 4s +
//    jq of group g, bit b of byte jh*n16 + g of hm = offset 2b + jh;
//    Q2_K: (d*sc) * q - dmin*mn;  Q3_K: (d*sc) * (q + 4*hbit - 4);
//  - Q2_K turbo: int8 in natural order, w = d*p - bm (bm the bf16 min
//    term of the group);  Q3_K turbo: int8 at o*n16 + g, w = a[g] * p;
//  - F8E5M2: the byte widened exactly (fp8.cuh) times the f32 block scale
//    s[r / b0][k0 / b1]; a 64-column step never straddles a scale block
//    (b1 % 64 == 0), and a partial edge block (a 576-row or 10944-column
//    weight) is a row or column index like any other.
// K6's prepermuted nibble body (kinds 10 and 11; the rp branch of
// deepseek_tpu/ops/matmul.py:268-285): x arrives in the stride-16 permuted
// order; natural column 16(g0+q) + o sits at o*n16 + g0 + q, so the x
// loader takes one float4 at each of the 16 offsets o*n16 + g0 (a narrow
// tile's group sums: over the 16 lanes that hold a group).
// Rows past d are read clamped and not stored; activation rows past the
// tile's live rows are staged as zeros and not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;     // two warp groups
constexpr int kBM = 128;          // activation rows per tile (at most)
constexpr int kBN = 128;          // weight rows (output columns) per block
constexpr int kBK = 64;           // columns per k-step
// MMA widths N by live rows (tile_width in ops/kernels/qmm.py)
constexpr int kW0 = 16, kW1 = 32, kW2 = 64, kW3 = kBM;
constexpr int kSBytes = 2 * kW1 * 16;           // narrow: two buffers of group sums
constexpr int kMaxSmem = 232448;     // a block's dynamic shared memory at most
constexpr int kSmSmem = 233472;      // an SM's, less 1 KB a resident block

// kinds 2-4 were the plain tables, now K11's own kernel (csrc/gmm.cu)
enum Kind { kNib = 0, kNibC = 1, kF8 = 5, kQ2 = 6, kQ3 = 7, kQ2T = 8, kQ3T = 9,
            kNibP = 10, kNibCP = 11 };

// the least MMA width that covers nr live rows
__device__ __forceinline__ int tile_width(int nr) {
  return nr <= kW0 ? kW0 : nr <= kW1 ? kW1 : nr <= kW2 ? kW2 : kW3;
}

// Raw slot layout of a kind: columns a slot, slots in the ring, and the
// byte offsets of its planes (rows of the block's kBN weight rows)
template <int KIND>
struct Slot {
  static constexpr bool kNibble = KIND == kNib || KIND == kNibC || KIND == kNibP ||
                                  KIND == kNibCP;
  static constexpr bool kHasC = KIND == kNibC || KIND == kNibCP;
  static constexpr bool kXPerm = KIND == kNibP || KIND == kNibCP;
  static constexpr bool kPacked = KIND == kQ2 || KIND == kQ3;
  static constexpr bool kBytes = KIND == kF8 || KIND == kQ2T;   // natural 1-byte planes
  static constexpr int SW = kBytes ? kBK : 256;   // columns a slot
  static constexpr int SPS = SW / kBK;            // k-steps a slot
  // slots in the ring; Q3_K turbo three, which also holds its narrow
  // kernel to one block an SM: at two its 1-byte plane's half-read
  // sectors, waiting in L2 for the next slot, took each step 1.8x as long
  // (H100)
  static constexpr int RING = kBytes ? 4 : KIND == kQ3T ? 3 : 2;
  // plane offsets in a slot
  static constexpr int P = 0;                     // nibble p, qs, turbo p, fp8 bytes
  static constexpr int P_BYTES = kNibble ? kBN * 128 : kPacked ? kBN * 64
                                 : KIND == kQ3T ? kBN * 256 : kBN * 64;
  static constexpr int A = P + P_BYTES;           // bf16 a / bm, or sm / sc bytes
  static constexpr int A_BYTES = (kNibble || KIND == kQ3T) ? kBN * 32
                                 : kPacked ? kBN * 16 : KIND == kQ2T ? kBN * 8 : 0;
  static constexpr int C = A + A_BYTES;           // nibble c, or Q3_K's hm
  static constexpr int C_BYTES = kHasC ? kBN * 32 : KIND == kQ3 ? kBN * 32 : 0;
  static constexpr int S = C + C_BYTES;           // f32 a row: super scale / fp8 scale
  static constexpr int S_BYTES = (kPacked || kBytes) ? kBN * 4 : 0;
  static constexpr int M = S + S_BYTES;           // f32 a row: Q2_K super mins
  static constexpr int M_BYTES = KIND == kQ2 ? kBN * 4 : 0;
  static constexpr int BYTES = M + M_BYTES;
  static_assert(BYTES % 16 == 0, "16-byte aligned slots");
  // the widest narrow tile: the fold's products a step (four k16 steps'
  // for the group-scaled kinds, one for the byte kinds) fit a narrow
  // kernel's 128 registers up to n16 / n32
  static constexpr int NARROW = kBytes ? kW1 : kW0;
};

// The kernel of one kind's narrow tiles (WIDE false: at most
// Slot::NARROW live rows; two blocks an SM) or of its wide ones (one block)
template <int KIND, bool WIDE>
struct Cfg {
  static constexpr int XROWS = WIDE ? kBM : Slot<KIND>::NARROW;   // x tile rows
  static constexpr int XPLANE = XROWS * 128;                    // one bf16 x tile
  static constexpr int XBYTES = 2 * 2 * XPLANE;                 // two buffers, hi + lo
  static constexpr int SMEM = 1024 + XBYTES + (WIDE ? 0 : kSBytes) +
                              Slot<KIND>::RING * Slot<KIND>::BYTES;   // + alignment
  static constexpr int BLOCKS = WIDE || KIND == kQ3T ? 1 : 2;   // blocks an SM
  static_assert(XPLANE % 1024 == 0, "1024-aligned x tiles");
  static_assert(SMEM <= kMaxSmem && (SMEM + 1024) * BLOCKS <= kSmSmem, "shared memory");
};

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

// No conversion instruction on the readers' path: on sm_90 int -> float
// and f32 -> bf16 conversions issue at an eighth of the FMA rate, and at
// a narrow tile the readers, not the MMAs, set the pace.
//  - a small integer u < 2^23 placed under the exponent of 2^23 reads as
//    2^23 + u: one OR and one FADD give float(u) - bias exactly
//    (kMagic + bias subtracted); a signed byte b is b ^ 0x80 = b + 128;
//  - split_rn: v = hi + lo in bf16, each rounded to nearest (ties away
//    from zero) by adding half an ulp of the 16 dropped bits to the
//    pattern: W - hi - lo within 2^-18 |W|, as with cvt.rn.
constexpr float kMagic = 8388608.f;   // 2^23
__device__ __forceinline__ float small_f(uint32_t u, float bias) {
  return __uint_as_float(0x4B000000u | u) - (kMagic + bias);
}
// byte k of w as a signed int8, in f32
__device__ __forceinline__ float s8_f(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440u | k)) -
         (kMagic + 128.f);
}
__device__ __forceinline__ void split_rn(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const uint32_t h0 = (__float_as_uint(v0) + 0x8000u) & 0xFFFF0000u;
  const uint32_t h1 = (__float_as_uint(v1) + 0x8000u) & 0xFFFF0000u;
  const uint32_t l0 = __float_as_uint(v0 - __uint_as_float(h0)) + 0x8000u;
  const uint32_t l1 = __float_as_uint(v1 - __uint_as_float(h1)) + 0x8000u;
  hi = __byte_perm(h0, h1, 0x7632u);
  lo = __byte_perm(l0, l1, 0x7632u);
}

// tile g -> (expert, first row, live rows); false for a tile with no rows
__device__ bool tile_of(const Tiles& t, int g, int& e, int& r0, int& nr) {
  e = t.tile_expert != nullptr ? t.tile_expert[g] : 0;
  r0 = g * kBM;
  nr = min(kBM, t.rows - r0);
  if (t.tile_rows != nullptr) nr = min(nr, t.tile_rows[g]);
  return nr > 0;
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(a), "r"(v));
}
__device__ __forceinline__ void sts64(uint32_t a, uint32_t v0, uint32_t v1) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" :: "r"(a), "r"(v0), "r"(v1));
}
__device__ __forceinline__ void sts16(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(a), "h"((unsigned short)v));
}

// word w (0..3) of a 16-byte chunk, without indexing registers
__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return (w & 2) ? ((w & 1) ? v.w : v.z) : ((w & 1) ? v.y : v.x);
}

// Q3_K turbo's 16 slab chunks of a row: slab o at chunk o ^ 2*(o/8) ^
// (r & 1), so the lanes of a half warp (four rows, slabs 4c + i) meet
// eight distinct 8-byte bank pairs, each twice
__device__ __forceinline__ int q3t_chunk(int o, int r) {
  return o ^ ((o >> 3) << 1) ^ (r & 1);
}

// scale_d 0 (narrow widths only): d = A . B
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                    uint64_t db, int scale_d = 1) {
  if constexpr (N == 16) wgmma_rs_n16_k(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32_k(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64_k(d, a, db);
  else wgmma_rs_n128_k(d, a, db);
}

// two bf16 lanes of 128 + k (k < 128, exact) minus 128 + b: the exact
// small integers k - b as a bf16 pair, one packed subtraction
__device__ __forceinline__ uint32_t bf16_ints(uint32_t k2, uint32_t bias2) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&k2),
                                   *reinterpret_cast<const __nv_bfloat162*>(&bias2));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// the bf16 pair of two f32 values that bf16 holds exactly
__device__ __forceinline__ uint32_t bf16_pair(float v0, float v1) {
  return __byte_perm(__float_as_uint(v0), __float_as_uint(v1), 0x7632u);
}

// The block's state, and one k-loop at MMA width N
template <int KIND, bool WIDE>
struct Block {
  using L = Slot<KIND>;
  static constexpr int XP = Cfg<KIND, WIDE>::XPLANE;
  const float* __restrict__ x;
  Weights wt;
  float* __restrict__ y;
  int d, n, e, r0, nr, col0;
  int tid, c, ra;             // c = lane % 4; ra: this lane's first fragment row
  uint32_t xbase, sums, ring; // shared addresses: x buffers, group sums, raw slots

  __device__ __forceinline__ int grow(int r) const { return min(col0 + r, d - 1); }

  // cp.async of raw slot `st` (columns st*SW..) into ring slot st % RING
  __device__ __forceinline__ void issue(int st) const {
    const uint32_t sl = ring + (st % L::RING) * L::BYTES;
    const int k0 = st * L::SW, n16 = n >> 4;
    if constexpr (L::kNibble) {
      const size_t half = (size_t)(n >> 1);
      const uint8_t* pe = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * half;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int item = tid + it * kThreads, r = item >> 3, o = item & 7;
        cp16(sl + L::P + r * 128 + ((o ^ (r & 7)) << 4),
             pe + grow(r) * half + (size_t)o * n16 + (k0 >> 4));
      }
      const int r = tid >> 1, h = tid & 1;
      const size_t off = (size_t)e * d * n16 + (size_t)grow(r) * n16 + (k0 >> 4) + h * 8;
      cp16(sl + L::A + r * 32 + h * 16, wt.a + off);
      if constexpr (L::kHasC) cp16(sl + L::C + r * 32 + h * 16, wt.c + off);
    } else if constexpr (L::kPacked) {
      const size_t n4 = (size_t)(n >> 2), n8 = (size_t)(n >> 3), n256 = (size_t)(n >> 8);
      const uint8_t* qe = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * n4;
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int item = tid + it * kThreads, r = item >> 2, j = item & 3;
        cp16(sl + L::P + r * 64 + j * 16, qe + grow(r) * n4 + (size_t)j * n16 + (k0 >> 4));
      }
      if constexpr (KIND == kQ3) {
        const int r = tid >> 1, j = tid & 1;
        cp16(sl + L::C + r * 32 + j * 16,
             wt.hm + (size_t)e * d * n8 + grow(r) * n8 + (size_t)j * n16 + (k0 >> 4));
      }
      if (tid < kBN) {
        const int r = tid;
        cp16(sl + L::A + r * 16, wt.s8 + (size_t)e * d * n16 + grow(r) * n16 + (k0 >> 4));
        cp4(sl + L::S + r * 4, wt.s + (size_t)e * d * n256 + grow(r) * n256 + (k0 >> 8));
      } else if constexpr (KIND == kQ2) {
        const int r = tid - kBN;
        cp4(sl + L::M + r * 4, wt.dmin + (size_t)e * d * n256 + grow(r) * n256 + (k0 >> 8));
      }
    } else if constexpr (KIND == kQ3T) {
      const uint8_t* pe = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * n;
#pragma unroll
      for (int it = 0; it < 8; ++it) {
        const int item = tid + it * kThreads, r = item >> 4, o = item & 15;
        cp16(sl + L::P + r * 256 + (q3t_chunk(o, r) << 4),
             pe + grow(r) * (size_t)n + (size_t)o * n16 + (k0 >> 4));
      }
      const int r = tid >> 1, h = tid & 1;
      cp16(sl + L::A + r * 32 + h * 16,
           wt.a + (size_t)e * d * n16 + grow(r) * n16 + (k0 >> 4) + h * 8);
    } else {
      static_assert(L::kBytes, "a reader for every kind");
      const uint8_t* we = static_cast<const uint8_t*>(wt.w) + (size_t)e * d * n;
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int item = tid + it * kThreads, r = item >> 2, j = item & 3;
        cp16(sl + L::P + r * 64 + j * 16, we + grow(r) * (size_t)n + k0 + j * 16);
      }
      if (tid < kBN) {
        const int r = tid, gr = grow(r);
        if constexpr (KIND == kF8) {
          const int g0 = (d + wt.b0 - 1) / wt.b0, g1 = (n + wt.b1 - 1) / wt.b1;
          cp4(sl + L::S + r * 4,
              wt.s + (size_t)e * g0 * g1 + (size_t)(gr / wt.b0) * g1 + k0 / wt.b1);
        } else {
          cp4(sl + L::S + r * 4,
              wt.s + (size_t)e * d * (n >> 8) + (size_t)gr * (n >> 8) + (k0 >> 8));
        }
      } else if constexpr (KIND == kQ2T) {
        const int r = tid - kBN;
        cp8(sl + L::A + r * 8, wt.a + (size_t)e * d * n16 + grow(r) * n16 + (k0 >> 4));
      }
    }
  }

  // the 16 activation values this thread moves a k-step: N rows x 64
  // columns as float4s, rows past the live ones zero
  template <int N>
  __device__ __forceinline__ void load_x(float4 (&xr)[N / 16], int k0) const {
#pragma unroll
    for (int it = 0; it < N / 16; ++it) {
      const int item = tid + it * kThreads, m = item >> 4, f = item & 15;
      const int col = L::kXPerm ? f * (n >> 4) + (k0 >> 4) : k0 + 4 * f;
      xr[it] = m < nr ? __ldg(reinterpret_cast<const float4*>(x + (size_t)(r0 + m) * n + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // the kinds whose dequantization subtracts a per-group term (nibble a*off
  // + c, Q2_K's dmin*mn, Q2_K turbo's bm): a narrow tile folds it against
  // the group sums of x
  static constexpr bool kSums = L::kNibble || KIND == kQ2 || KIND == kQ2T;

  // split them into bf16 hi + lo and store them into x buffer `buf` in the
  // kind's MMA column order (see the header); FOLD: and the f32 sums of
  // the step's four natural 16-column groups of each row into sums buffer
  // `buf` (16 bytes a row)
  template <int N, bool FOLD>
  __device__ __forceinline__ void store_x(const float4 (&xr)[N / 16], int buf) const {
    const uint32_t xh = xbase + buf * 2 * XP, xl = xh + XP;
#pragma unroll
    for (int it = 0; it < N / 16; ++it) {
      const int item = tid + it * kThreads, m = item >> 4, f = item & 15;
      if constexpr (FOLD && kSums) {
        const uint32_t sm = sums + buf * kW1 * 16 + m * 16;
        if constexpr (L::kXPerm) {
          // component q is natural group q: sum over the 16 offsets (lanes)
          float4 v = xr[it];
#pragma unroll
          for (int o = 1; o < 16; o <<= 1) {
            v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
            v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
            v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
            v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
          }
          if (f == 0) {
            sts64(sm, __float_as_uint(v.x), __float_as_uint(v.y));
            sts64(sm + 8, __float_as_uint(v.z), __float_as_uint(v.w));
          }
        } else {
          // natural columns 4f.. are a quarter of group f / 4: four lanes
          float v = (xr[it].x + xr[it].y) + (xr[it].z + xr[it].w);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if ((f & 3) == 0) sts32(sm + (f >> 2) * 4, __float_as_uint(v));
        }
      }
      uint32_t h0, l0, h1, l1;
      split_rn(xr[it].x, xr[it].y, h0, l0);
      split_rn(xr[it].z, xr[it].w, h1, l1);
      if constexpr (L::kNibble && !L::kXPerm) {
        // natural columns 4f.. at positions 4f..
        const uint32_t o = tile_e(m, kBM, 4 * f);
        sts64(xh + o, h0, h1);
        sts64(xl + o, l0, l1);
      } else if constexpr (KIND == kQ3T || L::kBytes) {
        // pairs (i = 0, 1) and (2, 3) at 16K + 2C and 16K + 2C + 8: Q3_K
        // turbo's natural 16K + 4C + i (K = f/4, C = f%4), the byte
        // kinds' 16C + 4K + i (C = f/4, K = f%4)
        const int K = KIND == kQ3T ? f >> 2 : f & 3, C = KIND == kQ3T ? f & 3 : f >> 2;
        const uint32_t o0 = tile_e(m, kBM, 16 * K + 2 * C);
        const uint32_t o1 = tile_e(m, kBM, 16 * K + 2 * C + 8);
        sts32(xh + o0, h0); sts32(xl + o0, l0);
        sts32(xh + o1, h1); sts32(xl + o1, l1);
      } else {
        const uint32_t hv[4] = {h0 & 0xFFFFu, h0 >> 16, h1 & 0xFFFFu, h1 >> 16};
        const uint32_t lv[4] = {l0 & 0xFFFFu, l0 >> 16, l1 & 0xFFFFu, l1 >> 16};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int pos;
          if constexpr (L::kXPerm) {
            pos = i * 16 + f;      // natural 16i + f, from permuted f*n16 + g0 + i
          } else {
            // packed: natural 4f + i = 16K + 4I + i -> c = i, 4-col I
            const int K = f >> 2, I = f & 3;
            pos = 16 * K + 2 * i + (I & 1) + 8 * (I >> 1);
          }
          const uint32_t o = tile_e(m, kBM, pos);
          sts16(xh + o, hv[i]);
          sts16(xl + o, lv[i]);
        }
      }
    }
  }

  // the dequantized fragment values of one row at k-step w of its slot
  // (sl) for the four k16 steps: v[kk][i], i as in the header
  struct Raw {                 // a row's raw words of the current slot
    uint4 p[2];                // nibble: slabs 2c, 2c+1; packed: qs, hm
    uint2 t[4];                // Q3_K turbo: slabs 4c + i, two steps' words
    float sup, mn;             // packed super scale (and Q2_K min)
  };
  // steps between two load_raw calls: a slot's (Q3_K turbo: two, so that
  // a narrow kernel's lane holds 16 registers of raw words, not 32)
  static constexpr int kRawSteps = KIND == kQ3T ? 2 : L::SPS;

  __device__ __forceinline__ void load_raw(Raw& rw, uint32_t sl, int r, int w) const {
    if constexpr (L::kNibble) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = 2 * c + j;
        rw.p[j] = lds128(sl + L::P + r * 128 + ((o ^ (r & 7)) << 4));
      }
    } else if constexpr (L::kPacked) {
      rw.p[0] = lds128(sl + L::P + r * 64 + c * 16);
      if constexpr (KIND == kQ3) rw.p[1] = lds128(sl + L::C + r * 32 + (c & 1) * 16);
      rw.sup = __uint_as_float(lds32(sl + L::S + r * 4));
      if constexpr (KIND == kQ2) rw.mn = __uint_as_float(lds32(sl + L::M + r * 4));
    } else if constexpr (KIND == kQ3T) {
      // 8 bytes of each of the 16-byte slab chunks 4c + i: steps w, w + 1
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rw.t[i] = lds64(sl + L::P + r * 256 + (q3t_chunk(4 * c + i, r) << 4) + (w >> 1) * 8);
    }
  }

  __device__ __forceinline__ void values(float (&v)[4][4], const Raw& rw, uint32_t sl,
                                         int r, int w) const {
    if constexpr (L::kNibble) {
      const uint2 a2 = lds64(sl + L::A + r * 32 + w * 8);
      uint2 c2 = make_uint2(0u, 0u);
      if constexpr (L::kHasC) c2 = lds64(sl + L::C + r * 32 + w * 8);
      const uint32_t w0 = word(rw.p[0], w), w1 = word(rw.p[1], w);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t aw = kk < 2 ? a2.x : a2.y, cw = kk < 2 ? c2.x : c2.y;
        const float af = bf16_f((aw >> (16 * (kk & 1))) & 0xFFFFu);
        const float cf = bf16_f((cw >> (16 * (kk & 1))) & 0xFFFFu);
        const uint32_t b0 = w0 >> (8 * kk), b1 = w1 >> (8 * kk);
        v[kk][0] = af * small_f(b0 & 0xFu, wt.off) - cf;
        v[kk][1] = af * small_f(b1 & 0xFu, wt.off) - cf;
        v[kk][2] = af * small_f((b0 >> 4) & 0xFu, wt.off) - cf;
        v[kk][3] = af * small_f((b1 >> 4) & 0xFu, wt.off) - cf;
      }
    } else if constexpr (L::kPacked) {
      const uint32_t sw = lds32(sl + L::A + r * 16 + w * 4);
      const uint32_t qw = word(rw.p[0], w);
      const uint32_t hw = KIND == kQ3 ? word(rw.p[1], w) : 0u;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b = (sw >> (8 * kk)) & 0xFFu;
        float scale, minv = 0.f;
        if constexpr (KIND == kQ2) {
          scale = rw.sup * small_f(b & 0xFu, 0.f);
          minv = rw.mn * small_f(b >> 4, 0.f);
        } else {
          scale = rw.sup * s8_f(sw, kk);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t q = (qw >> (8 * kk + 2 * i)) & 3u;
          if constexpr (KIND == kQ2) {
            v[kk][i] = scale * small_f(q, 0.f) - minv;
          } else {
            const uint32_t h = (hw >> (8 * kk + 2 * i + (c >> 1))) & 1u;
            v[kk][i] = scale * small_f(q | (h << 2), 4.f);   // q + 4h - 4
          }
        }
      }
    } else if constexpr (KIND == kQ3T) {
      const uint2 a2 = lds64(sl + L::A + r * 32 + w * 8);
      uint32_t sw[4];                                       // slabs 4c + i
#pragma unroll
      for (int i = 0; i < 4; ++i) sw[i] = (w & 1) ? rw.t[i].y : rw.t[i].x;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t aw = kk < 2 ? a2.x : a2.y;
        const float af = bf16_f((aw >> (16 * (kk & 1))) & 0xFFFFu);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[kk][i] = af * s8_f(sw[i], kk);
      }
    } else {
      // the 16 bytes 16c.. of the step: byte 4kk + i
      const uint4 raw = lds128(sl + L::P + r * 64 + c * 16);
      const float sc = __uint_as_float(lds32(sl + L::S + r * 4));
      if constexpr (KIND == kF8) {
        float f[16];
        e5m2x16(raw, f);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[kk][i] = f[4 * kk + i] * sc;
      } else {
        const uint32_t bw = lds32(sl + L::A + r * 8 + (c >> 1) * 4);
        const float bm = bf16_f((bw >> (16 * (c & 1))) & 0xFFFFu);
        const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[kk][i] = sc * s8_f(u[kk], i) - bm;
      }
    }
  }

  // Narrow tiles: the row's A values exactly, as bf16 fragment pairs p01
  // (values i = 0, 1) and p23 (i = 2, 3) for the four k16 steps (the
  // nibble, the 2-bit q or Q3_K's q + 4h - 4, the int8 turbo value, the
  // e5m2 byte: all exact in one bf16 term), and the fold terms: y +=
  // mul[kk] * P_kk - add[kk] * S_kk, P_kk the k16 step's product (the
  // byte kinds: one P for the step, mul[0] its scale, add[g] natural group
  // g's term).
  __device__ __forceinline__ void ints(uint32_t (&p01)[4], uint32_t (&p23)[4],
                                       float (&mul)[4], float (&add)[4], const Raw& rw,
                                       uint32_t sl, int r, int w) const {
    if constexpr (L::kNibble) {
      const uint2 a2 = lds64(sl + L::A + r * 32 + w * 8);
      uint2 c2 = make_uint2(0u, 0u);
      if constexpr (L::kHasC) c2 = lds64(sl + L::C + r * 32 + w * 8);
      const uint32_t w0 = word(rw.p[0], w), w1 = word(rw.p[1], w);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t aw = kk < 2 ? a2.x : a2.y, cw = kk < 2 ? c2.x : c2.y;
        mul[kk] = bf16_f((aw >> (16 * (kk & 1))) & 0xFFFFu);
        add[kk] = mul[kk] * wt.off + bf16_f((cw >> (16 * (kk & 1))) & 0xFFFFu);
        // byte kk of slab 2c in byte 0, of slab 2c + 1 in byte 2
        const uint32_t t = __byte_perm(w0, w1, kk | ((4 + kk) << 8));
        p01[kk] = bf16_ints((t & 0x000F000Fu) | 0x43004300u, 0x43004300u);
        p23[kk] = bf16_ints(((t >> 4) & 0x000F000Fu) | 0x43004300u, 0x43004300u);
      }
    } else if constexpr (L::kPacked) {
      const uint32_t sw = lds32(sl + L::A + r * 16 + w * 4);
      const uint32_t qw = word(rw.p[0], w);
      const uint32_t hw = KIND == kQ3 ? word(rw.p[1], w) >> (c >> 1) : 0u;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t qb = qw >> (8 * kk);
        // fields i = 0, 1 (bits 0-1, 2-3) to lanes 0, 1; i = 2, 3 likewise
        uint32_t lo = (qb & 3u) | ((qb & 0xCu) << 14);
        uint32_t hi = ((qb >> 4) & 3u) | ((qb & 0xC0u) << 10);
        if constexpr (KIND == kQ2) {
          const uint32_t b = (sw >> (8 * kk)) & 0xFFu;
          mul[kk] = rw.sup * small_f(b & 0xFu, 0.f);
          add[kk] = rw.mn * small_f(b >> 4, 0.f);
          p01[kk] = bf16_ints(lo | 0x43004300u, 0x43004300u);
          p23[kk] = bf16_ints(hi | 0x43004300u, 0x43004300u);
        } else {
          // the high bits 2i (+ c/2) of byte kk as 4h, then q + 4h - 4
          const uint32_t hb = hw >> (8 * kk);
          lo |= ((hb & 1u) << 2) | ((hb & 4u) << 16);
          hi |= ((hb >> 2) & 4u) | ((hb & 0x40u) << 12);
          mul[kk] = rw.sup * s8_f(sw, kk);
          add[kk] = 0.f;
          p01[kk] = bf16_ints(lo | 0x43004300u, 0x43044304u);
          p23[kk] = bf16_ints(hi | 0x43004300u, 0x43044304u);
        }
      }
    } else if constexpr (KIND == kQ3T) {
      const uint2 a2 = lds64(sl + L::A + r * 32 + w * 8);
      uint32_t sw[4];                                       // slabs 4c + i
#pragma unroll
      for (int i = 0; i < 4; ++i) sw[i] = (w & 1) ? rw.t[i].y : rw.t[i].x;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t aw = kk < 2 ? a2.x : a2.y;
        mul[kk] = bf16_f((aw >> (16 * (kk & 1))) & 0xFFFFu);
        add[kk] = 0.f;
        p01[kk] = bf16_pair(s8_f(sw[0], kk), s8_f(sw[1], kk));
        p23[kk] = bf16_pair(s8_f(sw[2], kk), s8_f(sw[3], kk));
      }
    } else {
      // the 16 bytes 16c.. of the step: byte 4kk + i
      const uint4 raw = lds128(sl + L::P + r * 64 + c * 16);
      const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
      mul[0] = __uint_as_float(lds32(sl + L::S + r * 4));
      if constexpr (KIND == kQ2T) {
        const uint2 b2 = lds64(sl + L::A + r * 8);
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2)
          add[g2] = bf16_f(((g2 < 2 ? b2.x : b2.y) >> (16 * (g2 & 1))) & 0xFFFFu);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (KIND == kF8) {
          // e5m2 -> half -> f32 (exact) -> its bf16 half (exact)
          const uint32_t lo = __byte_perm(u[kk], 0u, 0x1404u);   // bytes 0, 1
          const uint32_t hi = __byte_perm(u[kk], 0u, 0x3424u);   // bytes 2, 3
          const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&lo));
          const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&hi));
          p01[kk] = bf16_pair(a.x, a.y);
          p23[kk] = bf16_pair(b.x, b.y);
        } else {
          p01[kk] = bf16_pair(s8_f(u[kk], 0), s8_f(u[kk], 1));
          p23[kk] = bf16_pair(s8_f(u[kk], 2), s8_f(u[kk], 3));
        }
      }
    }
  }

  // y += the fold of one narrow step: mul * P_kk, less add * S over the
  // group sums of the step's x rows (sums buffer `buf`)
  template <int N, int NP>
  __device__ __forceinline__ void fold(float (&acc)[N / 8][4], const float (&pk)[NP][N / 8][4],
                                       const float (&mul)[2][4], const float (&add)[2][4],
                                       int buf) const {
#pragma unroll
    for (int t = 0; t < N / 8; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float sg[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kSums) {
          const uint4 sv = lds128(sums + buf * kW1 * 16 + (8 * t + 2 * c + j) * 16);
          sg[0] = __uint_as_float(sv.x); sg[1] = __uint_as_float(sv.y);
          sg[2] = __uint_as_float(sv.z); sg[3] = __uint_as_float(sv.w);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[t][2 * h + j];
#pragma unroll
          for (int q = 0; q < NP; ++q) v = fmaf(mul[h][q], pk[q][t][2 * h + j], v);
          if constexpr (kSums) {
#pragma unroll
            for (int q = 0; q < 4; ++q) v = fmaf(-add[h][q], sg[q], v);
          }
          acc[t][2 * h + j] = v;
        }
      }
  }

  // One tile at MMA width N. Wide tiles (N 64, 128): the dequantized f32
  // W split into hi + lo, three passes. Narrow tiles (N <= 32, FOLD): the
  // readers' exact integer (or e5m2) values as A, two passes (x hi, x lo)
  // into a product a k16 step (a step for the byte kinds), folded into the
  // accumulators with the per-group scale and min term after the step's
  // wait; a fifth of the readers' work a weight, where the readers set the
  // pace.
  template <int N>
  __device__ __forceinline__ void run() const {
    constexpr bool FOLD = !WIDE;
    constexpr int NP = L::kBytes ? 1 : 4;          // narrow: products a step
    const int steps = n / kBK, slots = n / L::SW;
    float acc[N / 8][4];
#pragma unroll
    for (int t = 0; t < N / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
    float pk[FOLD ? NP : 1][N / 8][4];
    float4 xr[N / 16];

    for (int st = 0; st < L::RING - 1; ++st) {
      if (st < slots) issue(st);
      cp_commit();
    }
    load_x<N>(xr, 0);
    store_x<N, FOLD>(xr, 0);
    if (steps > 1) load_x<N>(xr, kBK);
    cp_wait<L::RING - 2>();
    proxy_fence();
    __syncthreads();

    Raw rw[2];
    for (int s = 0; s < steps; ++s) {
      const int w = s % L::SPS, st = s / L::SPS;
      const uint32_t sl = ring + (st % L::RING) * L::BYTES;
      if (w == 0) {
        // the slot of st - 1 is free: refill it RING - 1 slots ahead
        if (st + L::RING - 1 < slots) issue(st + L::RING - 1);
        cp_commit();
      }
      if (w % kRawSteps == 0) {
        load_raw(rw[0], sl, ra, w);
        load_raw(rw[1], sl, ra + 8, w);
      }
      const uint32_t xh = xbase + (s & 1) * 2 * XP, xl = xh + XP;
      float mul[2][4], add[2][4];
      if constexpr (FOLD) {
        // this lane's exact A fragments for the four k16 steps
        uint32_t af[4][4];
        {
          uint32_t p01[2][4], p23[2][4];
          ints(p01[0], p23[0], mul[0], add[0], rw[0], sl, ra, w);
          ints(p01[1], p23[1], mul[1], add[1], rw[1], sl, ra + 8, w);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            af[kk][0] = p01[0][kk]; af[kk][1] = p01[1][kk];
            af[kk][2] = p23[0][kk]; af[kk][3] = p23[1][kk];
          }
        }
#pragma unroll
        for (int q = 0; q < NP; ++q) pin(pk[q]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float (&pq)[N / 8][4] = pk[L::kBytes ? 0 : kk];
          mma<N>(pq, af[kk], desc(xh + kk * 32, 16, 1024), L::kBytes && kk > 0 ? 1 : 0);
          mma<N>(pq, af[kk], desc(xl + kk * 32, 16, 1024));
        }
      } else {
        // this lane's A fragments, hi and lo, for the four k16 steps; each
        // k16 step's three passes issue as soon as its fragments are made,
        // so the next step's dequantization runs beside them
        uint32_t ah[4][4], al[4][4];
        float va[4][4], vb[4][4];
        values(va, rw[0], sl, ra, w);
        values(vb, rw[1], sl, ra + 8, w);
        pin(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          split_rn(va[kk][0], va[kk][1], ah[kk][0], al[kk][0]);
          split_rn(vb[kk][0], vb[kk][1], ah[kk][1], al[kk][1]);
          split_rn(va[kk][2], va[kk][3], ah[kk][2], al[kk][2]);
          split_rn(vb[kk][2], vb[kk][3], ah[kk][3], al[kk][3]);
          wg_fence();
          // 32 bytes a k16 step inside the 128-byte rows of the x tile
          const uint64_t dh = desc(xh + kk * 32, 16, 1024);
          mma<N>(acc, ah[kk], dh);
          mma<N>(acc, ah[kk], desc(xl + kk * 32, 16, 1024));
          mma<N>(acc, al[kk], dh);
        }
      }
      wg_commit();
      if (s + 1 < steps) {
        store_x<N, FOLD>(xr, (s + 1) & 1);
        if (s + 2 < steps) load_x<N>(xr, (s + 2) * kBK);
      }
      wg_wait();
      if constexpr (FOLD) {
#pragma unroll
        for (int q = 0; q < NP; ++q) pin(pk[q]);
        fold<N, NP>(acc, pk, mul, add, s & 1);
      } else {
        pin(acc);
      }
      if (w == L::SPS - 1) cp_wait<L::RING - 2>();
      proxy_fence();
      __syncthreads();   // x buffer s & 1 and a finished slot free; the next slot landed
    }

    // acc[t] holds weight rows ra (+8) x activation rows 8t + 2c (+1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + ra + 8 * h;
      if (col >= d) continue;
#pragma unroll
      for (int t = 0; t < N / 8; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = 8 * t + 2 * c + j;
          if (m < nr) y[(size_t)(r0 + m) * d + col] = acc[t][2 * h + j];
        }
    }
  }
};

template <int KIND, bool WIDE>
__global__ void __launch_bounds__(kThreads, (Cfg<KIND, WIDE>::BLOCKS))
tile_gemm_kernel(const float* __restrict__ x, Weights wt, Tiles tl,
                 float* __restrict__ y, int d, int n) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Block<KIND, WIDE> b{x, wt, y, d, n};
  if (!tile_of(tl, blockIdx.x, b.e, b.r0, b.nr)) return;
  if ((b.nr > Slot<KIND>::NARROW) != WIDE) return;    // the other kernel's tile
  b.col0 = blockIdx.y * kBN;
  b.tid = threadIdx.x;
  const int lane = b.tid & 31, warp = b.tid >> 5;
  b.c = lane & 3;
  b.ra = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);   // its warp's row g
  b.xbase = (smem_addr(smem_raw) + 1023u) & ~1023u;
  b.sums = b.xbase + Cfg<KIND, WIDE>::XBYTES;
  b.ring = b.sums + (WIDE ? 0 : kSBytes);
  const int width = tile_width(b.nr);               // block-uniform
  if constexpr (WIDE) {
    if (width == kW3) b.template run<kW3>();
    else if (width == kW2) b.template run<kW2>();
    else if constexpr (Slot<KIND>::NARROW < kW1) b.template run<kW1>();
  } else {
    if (width == kW0) b.template run<kW0>();
    else if constexpr (Slot<KIND>::NARROW >= kW1) b.template run<kW1>();
  }
}

template <int KIND, bool WIDE>
cudaError_t launch_one(const float* x, const Weights& wt, const Tiles& tl,
                       float* y, int G, int d, int n, cudaStream_t stream) {
  constexpr int smem = Cfg<KIND, WIDE>::SMEM;
  static bool smem_opt_in = false;
  if (!smem_opt_in) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_gemm_kernel<KIND, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_opt_in = true;
  }
  dim3 grid(G, (d + kBN - 1) / kBN);
  tile_gemm_kernel<KIND, WIDE><<<grid, kThreads, smem, stream>>>(x, wt, tl, y, d, n);
  return cudaGetLastError();
}

// the narrow tiles' kernel, then the wide tiles' (each skips the other's)
template <int KIND>
cudaError_t launch(const float* x, const Weights& wt, const Tiles& tl,
                   float* y, int G, int d, int n, cudaStream_t stream) {
  cudaError_t err = launch_one<KIND, false>(x, wt, tl, y, G, d, n, stream);
  if (err == cudaSuccess) err = launch_one<KIND, true>(x, wt, tl, y, G, d, n, stream);
  return err;
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
// 256 == 0; fp8: b1 % 64 == 0), 16-byte aligned planes and x, G <= 2^31 -
// 1, d <= 8388480. Returns a cudaError_t; the launch is asynchronous on
// `stream`.
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
