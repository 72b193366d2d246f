// The nibble matvec for Hopper (sm_90a): K1 (deepseek_tpu/ops/pallas/qmm.py
// :312 qmm with _knib_body :206, pallas_call :400: every nibble projection
// and the lm_head at 1-4 rows) and K2's nibble bodies (qmm.py:566
// qmm_experts, the same body, pallas_call :710: the MoE tables and the
// per-head wv_b; x natural or already in the stride-16 permuted order in
// which a row-permuted w13 leaves h, :602-609).
//
//   y[b, r] = sum_g a[r, g] * sum_{k<16} x[b, 16g + k] * (u[r, 16g + k] - off)
//             - sum_g c[r, g] * sum_{k<16} x[b, 16g + k]
//
// with u the 4-bit quant of natural column 16g + k: the low nibble of plane
// byte k*n16 + g for k < 8, the high nibble of byte (k - 8)*n16 + g else
// (n16 = n/16); a, c bf16 per 16-column group (c may be absent).
//
// Bound: bytes. The planes hold 4.5 bits a weight (5.5 with c): at 3.35
// TB/s about 6e12 weights a second, against ~3.0e13 lane instructions a
// second the SMs issue, so a weight may cost a few instructions at one x
// row and must stay near one a row beyond. The design:
//  - integer products (the packed matvec's, csrc/packed_mv.cu): a pre-pass
//    (xsplit.cuh, once per x row a call) splits each 16-column group
//    of x into two int8 terms, x ~ s2 (254 a + b) with s1 = max|x_g| / 127,
//    a = rint(x / s1), s2 = s1 / 254, b = rint((x - s1 a) / s2) (~15 bits
//    of each x; one int8 term misses the 1e-4 oracle 45-90 times over), in
//    natural column order from x in its own dtype (f32, f16, bf16, natural
//    or permuted: no cast launch); the quants are small unsigned integers,
//    so __dp4a gives 4 exact products an instruction and a group costs, per
//    weight row and x row, 8 dp4a, two integer multiply-adds, one convert,
//    one multiply and one FMA (without c, off enters as the integer start
//    -off (254 sum a + sum b) from the pre-pass; with c, off * a + c meets
//    the group's f32 sum of x);
//  - unpacking: two 4 x 4 byte transposes (12 byte-permutes for 4 groups)
//    put a group's bytes at offsets 0-3 and 4-7 in one word each, whose low
//    and high nibbles are the quants of columns 0-3, 8-11 and 4-7, 12-15,
//    one mask (and a shift) a word: the order of the x terms;
//  - superblock-wide loads: a lane takes 16 consecutive groups (256
//    columns) of a row a step: 16 bytes at each of the 8 plane offsets
//    o*n16 + 16 sb, and the 16 groups' a (and c), every load of a step
//    issued before its arithmetic and streamed past L1 (read once), the
//    lanes of a row on consecutive superblocks (coalesced); the x terms,
//    laid out by (term, group in superblock, superblock), stay in L1, the
//    next group's loaded before this group's arithmetic at 1-2 x rows;
//  - a persistent grid of warp items: an item is one weight row for each of
//    a warp's 32 / LPR lane subgroups (LPR lanes a row, from the
//    superblocks a row has, so short rows such as n = 1536 or 512 still
//    fill the warp), of one expert, for ALL x rows (K1: 1-4, each weight
//    byte read once a call; K2: its one pair); the wrapper sizes the warps
//    (ops/kernels/qmm.py::nibble_warps): as many as the card holds at this
//    kernel's launch bounds, fewer where that spreads the items more
//    evenly, in blocks of two warps so that even a short launch reaches
//    every SM;
//  - the first plane loads wait for nothing: the matvec is launched with
//    programmatic stream serialization behind the pre-pass and waits for it
//    (griddepcontrol.wait) only after its first loads have left; the terms
//    are read with plain loads (a non-coherent load may be moved above the
//    wait).
// K2's expert ids are read as given (int32 or int64), unchecked. f32
// accumulation from the exact integer group sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xsplit.cuh"

namespace {

constexpr int kNbThreads = 64;       // 2 warps a block
constexpr int kNbMaxX = 4;           // x rows a K1 launch takes at most
constexpr int kNbBlocksFew = 8;      // blocks an SM (launch bounds) at 1-2 x rows
constexpr int kNbBlocksMany = 6;     // at 3-4 x rows
constexpr int kNbMaxOff = 8;         // |off| at most: the integer group sums stay below 2^24

// one step's slabs: a superblock of one row: the 8 plane offsets, a, c
struct Step {
  uint4 q[8], a[2], c[2];
};

struct Planes {
  const uint8_t* p;
  const uint16_t *a, *c;
};

template <bool HAS_C>
__device__ __forceinline__ void load_step(Step& st, const Planes& pl, size_t rw, int sb, int n) {
  const size_t half = (size_t)(n >> 1), n16 = (size_t)(n >> 4), g0 = (size_t)sb << 4;
  const uint8_t* pr = pl.p + rw * half + g0;
#pragma unroll
  for (int o = 0; o < 8; ++o) st.q[o] = ld_stream(pr + o * n16);
  const uint16_t* ar = pl.a + rw * n16 + g0;
  st.a[0] = ld_stream(ar);
  st.a[1] = ld_stream(ar + 8);
  if constexpr (HAS_C) {
    const uint16_t* cr = pl.c + rw * n16 + g0;
    st.c[0] = ld_stream(cr);
    st.c[1] = ld_stream(cr + 8);
  }
}

__device__ __forceinline__ float bf16_at(const uint4 (&v)[2], int j) {
  const uint32_t w = word(v[j >> 3], (j >> 1) & 3);
  return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// NB x rows (K1), or one x row per pair (EXPERTS, K2: NB = 1)
template <bool HAS_C, int NB, bool EXPERTS>
__global__ void __launch_bounds__(kNbThreads, NB <= 2 ? kNbBlocksFew : kNbBlocksMany)
nib_mv_kernel(const uint4* terms, const float2* aux, Planes pl, const void* __restrict__ idx,
              int idx64, float* __restrict__ y, int pairs, int d, int n, int lpr_shift,
              float off) {
  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_shift, sl = lane & (lpr - 1);
  const int warp_rows = 32 >> lpr_shift;
  const int per_pair = (d + warp_rows - 1) / warp_rows;     // items of one pair
  const int items = (EXPERTS ? pairs : 1) * per_pair;
  const int nsb = n >> 8;
  const int warps = gridDim.x * (kNbThreads / 32);
  bool waited = false;
  for (int item = blockIdx.x * (kNbThreads / 32) + (threadIdx.x >> 5); item < items;
       item += warps) {
    const int b = EXPERTS ? item / per_pair : 0;
    const int row = (item - b * per_pair) * warp_rows + (lane >> lpr_shift);
    size_t e = 0;
    if (EXPERTS)
      e = idx64 ? (size_t) static_cast<const int64_t*>(idx)[b]
                : (size_t) static_cast<const int32_t*>(idx)[b];
    const size_t rw = e * d + min(row, d - 1);               // clamped: stores masked
    float acc[NB];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[bb] = 0.f;

    for (int sb = sl; sb < nsb; sb += lpr) {
      Step st;
      load_step<HAS_C>(st, pl, rw, sb, n);
      if (!waited) {                             // the pre-pass's terms from here on
        asm volatile("griddepcontrol.wait;" ::: "memory");
        waited = true;
      }
      // the x terms: at 1-2 x rows the next group's in flight during this
      // group's arithmetic; at 3-4 (registers) each group's when it comes
      constexpr bool kAhead = NB <= 2;
      XTerms<NB> xt;
      if (kAhead) load_x<NB, EXPERTS>(xt, terms, aux, b, 0, sb, nsb);
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {           // groups 16 sb + 4 qd .. + 3
        uint32_t tl[4], th[4];                   // bytes at offsets 0-3 and 4-7 a group
        transpose4(word(st.q[0], qd), word(st.q[1], qd), word(st.q[2], qd), word(st.q[3], qd),
                   tl);
        transpose4(word(st.q[4], qd), word(st.q[5], qd), word(st.q[6], qd), word(st.q[7], qd),
                   th);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * qd + k;
          if (!kAhead) load_x<NB, EXPERTS>(xt, terms, aux, b, j, sb, nsb);
          const XTerms<NB> cur = xt;
          if (kAhead && j < 15) load_x<NB, EXPERTS>(xt, terms, aux, b, j + 1, sb, nsb);
          // columns 0-3, 4-7, 8-11, 12-15 of the group, a byte each
          const uint32_t u0 = tl[k] & 0x0F0F0F0Fu, u1 = th[k] & 0x0F0F0F0Fu;
          const uint32_t u2 = (tl[k] >> 4) & 0x0F0F0F0Fu, u3 = (th[k] >> 4) & 0x0F0F0F0Fu;
          const float fa = bf16_at(st.a, j);
          float fm = 0.f;                        // with c: off * a + c against sum x
          if constexpr (HAS_C) fm = fmaf(off, fa, bf16_at(st.c, j));
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) {
            const uint4 xa = cur.a[bb], xb = cur.b[bb];
            const float2 ax = cur.s[bb];
            const int init = HAS_C ? 0 : __float_as_int(ax.y);
            int sa = __dp4a((int)xa.x, (int)u0, 0);
            int sbv = __dp4a((int)xb.x, (int)u0, init);
            sa = __dp4a((int)xa.y, (int)u1, sa);
            sbv = __dp4a((int)xb.y, (int)u1, sbv);
            sa = __dp4a((int)xa.z, (int)u2, sa);
            sbv = __dp4a((int)xb.z, (int)u2, sbv);
            sa = __dp4a((int)xa.w, (int)u3, sa);
            sbv = __dp4a((int)xb.w, (int)u3, sbv);
            const int c = sa * 254 + sbv;        // exact: |c| < 2^24 for |off| <= 8
            acc[bb] = fmaf(fa, ax.x * (float)c, acc[bb]);
            if constexpr (HAS_C) acc[bb] = fmaf(-fm, ax.y, acc[bb]);
          }
        }
      }
    }

#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
      for (int m = lpr >> 1; m > 0; m >>= 1)
        acc[bb] += __shfl_xor_sync(0xffffffffu, acc[bb], m);
    if (sl == 0 && row < d) {
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) y[(size_t)(EXPERTS ? b : bb) * d + row] = acc[bb];
    }
  }
}

struct Args {
  const uint4* terms;
  const float2* aux;
  Planes pl;
  const void* idx;
  int idx64;
  float* y;
  int pairs, d, n, lpr_shift, blocks;
  float off;
};

// the matvec behind the pre-pass, allowed to start before the pre-pass ends
template <bool HAS_C, int NB, bool EXPERTS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return launch_behind(nib_mv_kernel<HAS_C, NB, EXPERTS>, a.blocks, kNbThreads, stream, a.terms,
                       a.aux, a.pl, a.idx, a.idx64, a.y, a.pairs, a.d, a.n, a.lpr_shift, a.off);
}

template <bool HAS_C>
cudaError_t dispatch(const Args& a, int rows_x, cudaStream_t stream) {
  if (a.idx != nullptr) return launch<HAS_C, 1, true>(a, stream);
  switch (rows_x) {
    case 1: return launch<HAS_C, 1, false>(a, stream);
    case 2: return launch<HAS_C, 2, false>(a, stream);
    case 3: return launch<HAS_C, 3, false>(a, stream);
    case 4: return launch<HAS_C, 4, false>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (rows_x, d) f32 = nibble matvec of x (rows_x, n) in dtype x_dtype (0
// f32, 1 f16, 2 bf16), natural column order (x_perm 0) or stride-16
// permuted (1). Planes p (E, d, n/2) u8, a and c (E, d, n/16) bf16 (c may
// be null), |off| <= kNbMaxOff. idx (rows_x,) of idx_bytes 4 (int32) or 8
// (int64) selects the expert of each row (K2), or is null with E = 1 and
// rows_x <= kNbMaxX (K1). scratch: rows_x * n/16 * 40 bytes, 16-byte
// aligned (the pre-pass's terms, then its group scalars). lanes: lanes a
// row (a power of two up to 32), warps: the persistent warps
// (ops/kernels/qmm.py::packed_lanes, nibble_warps). Needs n % 256 == 0 and
// 16-byte aligned planes. Returns a cudaError_t; the two launches are
// asynchronous on `stream`.
extern "C" int nibble_mv(const void* x, int x_dtype, int x_perm, const void* p,
                         const void* a, const void* c, int off, const void* idx,
                         int idx_bytes, void* scratch, void* y, int rows_x, int d, int n,
                         int lanes, int warps, void* stream) {
  if (rows_x <= 0 || d <= 0 || n <= 0 || n % 256 != 0 || warps <= 0 || x_dtype < 0 ||
      x_dtype > 2 || lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      off < -kNbMaxOff || off > kNbMaxOff || x == nullptr || p == nullptr || a == nullptr ||
      scratch == nullptr || y == nullptr || (idx == nullptr && rows_x > kNbMaxX) ||
      (idx != nullptr && idx_bytes != 4 && idx_bytes != 8) ||
      (long long)rows_x * (n / 16) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int groups = rows_x * (n / 16), has_c = c != nullptr;
  auto terms = static_cast<uint4*>(scratch);
  auto aux = reinterpret_cast<float2*>(terms + 2 * (size_t)groups);
  // without c, off as the integer start; with c, (off a + c) against the f32 sum
  cudaError_t err = launch_xsplit(x, x_dtype, x_perm, terms, aux, groups, n, off, has_c, st);
  if (err != cudaSuccess) return (int)err;
  const Args args{terms, aux,
                  Planes{static_cast<const uint8_t*>(p), static_cast<const uint16_t*>(a),
                         static_cast<const uint16_t*>(c)},
                  idx, idx_bytes == 8 ? 1 : 0, static_cast<float*>(y), rows_x, d, n,
                  __builtin_ctz(lanes), (warps + kNbThreads / 32 - 1) / (kNbThreads / 32),
                  (float)off};
  err = has_c ? dispatch<true>(args, rows_x, st) : dispatch<false>(args, rows_x, st);
  return (int)err;
}
