// The packed Q2_K/Q3_K matvec for Hopper (sm_90a): the packed bodies of
// K5 (deepseek_tpu/ops/pallas/qmm.py:312 qmm with _q2k_body :143, launched
// :361, and _q3k_body :156, launched :368: Q2_K/Q3_K projections at 1-4
// rows) and K2 (qmm.py:566 qmm_experts, the same bodies chosen :622-629,
// launched :710: packed expert tables and the per-head wv_b).
//
//   y[b, r] = sum_c x[b, c] * w[idx[b]][r, c]
//   Q2_K: w = d * (sm & 15) * q - dmin * (sm >> 4),  q in 0..3
//   Q3_K: w = d * sc * (u - 4),  u = qlow + 4 * hbit in 0..7
//
// with d (and dmin) per 256-column superblock, sm / sc per 16-column group.
// Plane layout (quant/repack.py; n16 = n/16): byte jq*n16 + g of the 2-bit
// plane qs (jq = 0..3) holds in bits 2s..2s+1 the quant of natural column
// 16g + 4s + jq; byte jh*n16 + g of the 1-bit plane hm holds in bit b the
// high bit of natural column 16g + 2b + jh. So the 16 groups g0..g0+15 of
// one superblock are 16 contiguous bytes at each of the offsets jq*n16 +
// g0 (qs), jh*n16 + g0 (hm) and g0 (sc / sm).
//
// Bound: bytes. The planes hold 2.75 bits a weight for Q2_K (qs n/4, sm
// n/16, f32 d and dmin n/256) and 3.625 for Q3_K (qs n/4, hm n/8, sc n/16,
// f32 d n/256). At 3.35 TB/s that streams 9.7e12 Q2_K or 7.4e12 Q3_K
// weights a second, against ~3.0e13 lane instructions a second the SMs
// issue: about 3 instructions a weight for Q2_K and 4 for Q3_K. The design
// keeps the work a weight well under that:
//  - integer products: a pre-pass (xsplit.cuh, once per x row a call, x
//    read in its own dtype: f32, f16 or bf16, no cast launch) splits each
//    16-column group of x into two int8 terms, x ~ s2 * (254 a + b) with
//    s1 = max|x_g| / 127, a = rint(x / s1), s2 = s1 / 254 and b = rint((x -
//    s1 a) / s2) (~15 bits of each x, as split-bf16 operands carry; the
//    divisions are multiplies by rounded reciprocals of max|x_g|);
//    the weights' quants are already small unsigned integers, so __dp4a
//    gives 4 exact products an instruction, and a group costs, per weight
//    row, 8 dp4a, two integer multiply-adds, one convert and one FMA (Q3_K's
//    -4 enters as the accumulator's start, -4 (254 sum a + sum b), made by
//    the pre-pass; Q2_K's min term takes the group's f32 sum of x);
//  - unpacking: a 4 x 4 byte transpose (8 byte-permutes for 4 groups) puts
//    a group's 4 qs bytes in one word, whose 2-bit fields a shift and a mask
//    turn into 4 quants of 4 consecutive natural columns, the order of the
//    x terms; Q3_K's high bits are moved beside them with two more masks;
//  - superblock-wide loads: a lane takes one superblock of a row a step,
//    16-byte loads of its 4 qs (Q3_K also 2 hm) slabs and its scale slab,
//    and one f32 d (Q2_K also dmin), for kPkRows rows, every load of a step
//    issued before its arithmetic; the planes bypass L1 (read once), the x
//    terms, laid out so that a warp's lanes (one superblock each) read
//    consecutive 16 bytes, stay in it, the next group's loaded before this
//    group's arithmetic;
//  - a persistent grid of warp items: an item is kPkRows rows for each of a
//    warp's 32 / LPR lane subgroups (LPR lanes a row, from the superblocks a
//    row has, so short rows such as n = 1536 or 512 still fill the warp),
//    of one expert, for ALL x rows (K5: 1-4, so each weight byte is read
//    once a call; K2: its one pair); the wrapper sizes the warps
//    (ops/kernels/qmm.py::packed_warps): as many as the card holds at this
//    kernel's launch bounds, fewer where that spreads the items more evenly,
//    in blocks of two warps so that even a short launch reaches every SM;
//  - the first plane loads wait for nothing: the matvec is launched with
//    programmatic stream serialization behind the pre-pass and waits for it
//    (griddepcontrol.wait) only after its first loads have left.
// K2's expert ids are read as given (int32 or int64), unchecked. f32
// accumulation from the exact integer group sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xsplit.cuh"

namespace {

constexpr int kPkThreads = 64;       // 2 warps a block
constexpr int kPkRows = 2;           // weight rows a lane subgroup holds
constexpr int kPkMaxX = 4;           // x rows a K5 launch takes at most
constexpr int kPkBlocksFew = 8;      // blocks an SM (launch bounds) at 1-2 x rows
constexpr int kPkBlocksMany = 6;     // at 3-4 x rows

// Q3_K's high bits of 4 groups in the transposed layout: h[k] byte jq holds,
// in bit 2s, the high bit of natural column 16g + 4s + jq (g the quad's
// group k): bit 2s + jq/2 of hm byte (jq % 2) (m0, m1: the jh = 0, 1 words;
// bit 7 of each byte is left undefined and never read).
__device__ __forceinline__ void high_bits(uint32_t m0, uint32_t m1, uint32_t h[4]) {
  const uint32_t lo = __byte_perm(m0, m1, 0x5140), hi = __byte_perm(m0, m1, 0x7362);
  const uint32_t lo1 = lo >> 1, hi1 = hi >> 1;
  h[0] = __byte_perm(lo, lo1, 0x5410);
  h[1] = __byte_perm(lo, lo1, 0x7632);
  h[2] = __byte_perm(hi, hi1, 0x5410);
  h[3] = __byte_perm(hi, hi1, 0x7632);
}

// the quants of one group as 4 words: u[s] byte jq = the quant of natural
// column 16g + 4s + jq (t: the group's transposed qs word; h: its high bits)
template <bool Q3>
__device__ __forceinline__ void unpack(uint32_t t, uint32_t h, uint32_t u[4]) {
  if constexpr (Q3) {
    // fields s = 0, 2 (E) and 1, 3 (O) as 3-bit values at bits 0 and 4
    const uint32_t e = (t & 0x33333333u) | ((h << 2) & 0x44444444u);
    const uint32_t o = ((t >> 2) & 0x33333333u) | (h & 0x44444444u);
    u[0] = e & 0x07070707u;
    u[1] = o & 0x07070707u;
    u[2] = (e >> 4) & 0x07070707u;
    u[3] = (o >> 4) & 0x07070707u;
  } else {
    u[0] = t & 0x03030303u;
    u[1] = (t >> 2) & 0x03030303u;
    u[2] = (t >> 4) & 0x03030303u;
    u[3] = (t >> 6) & 0x03030303u;
  }
}

// one step's plane slabs: a superblock of kPkRows rows
struct Step {
  uint4 q[kPkRows][4], h[kPkRows][2], sc[kPkRows];
  float dv[kPkRows], mv[kPkRows];
};

struct Planes {
  const uint8_t *qs, *hm, *s8;
  const float *dsup, *dmin;
};

template <bool Q3>
__device__ __forceinline__ void load_step(Step& st, const Planes& p, const size_t (&rw)[kPkRows],
                                          int sb, int n) {
  const size_t n4 = (size_t)(n >> 2), n8 = (size_t)(n >> 3), n16 = (size_t)(n >> 4);
  const size_t n256 = (size_t)(n >> 8), g0 = (size_t)sb << 4;
#pragma unroll
  for (int rr = 0; rr < kPkRows; ++rr) {
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) st.q[rr][jq] = ld_stream(p.qs + rw[rr] * n4 + jq * n16 + g0);
    if constexpr (Q3) {
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) st.h[rr][jh] = ld_stream(p.hm + rw[rr] * n8 + jh * n16 + g0);
    }
    st.sc[rr] = ld_stream(p.s8 + rw[rr] * n16 + g0);
    st.dv[rr] = __ldg(p.dsup + rw[rr] * n256 + sb);
    if constexpr (!Q3) st.mv[rr] = __ldg(p.dmin + rw[rr] * n256 + sb);
  }
}

// NB x rows (K5), or one x row per pair (EXPERTS, K2: NB = 1)
template <bool Q3, int NB, bool EXPERTS>
__global__ void __launch_bounds__(kPkThreads, NB <= 2 ? kPkBlocksFew : kPkBlocksMany)
packed_mv_kernel(const uint4* terms, const float2* aux, Planes p,
                 const void* __restrict__ idx, int idx64, float* __restrict__ y, int pairs,
                 int d, int n, int lpr_shift) {
  const int lane = threadIdx.x & 31;
  const int lpr = 1 << lpr_shift, sl = lane & (lpr - 1);
  const int warp_rows = (32 >> lpr_shift) * kPkRows;
  const int per_pair = (d + warp_rows - 1) / warp_rows;     // items of one pair
  const int items = (EXPERTS ? pairs : 1) * per_pair;
  const int nsb = n >> 8;
  const int warps = gridDim.x * (kPkThreads / 32);
  bool waited = false;
  for (int item = blockIdx.x * (kPkThreads / 32) + (threadIdx.x >> 5); item < items;
       item += warps) {
    const int b = EXPERTS ? item / per_pair : 0;
    const int row0 = (item - b * per_pair) * warp_rows + (lane >> lpr_shift) * kPkRows;
    size_t e = 0;
    if (EXPERTS)
      e = idx64 ? (size_t)static_cast<const int64_t*>(idx)[b]
                : (size_t)static_cast<const int32_t*>(idx)[b];
    size_t rw[kPkRows];                          // clamped rows: stores are masked
#pragma unroll
    for (int rr = 0; rr < kPkRows; ++rr) rw[rr] = e * d + min(row0 + rr, d - 1);

    float acc[kPkRows][NB];
#pragma unroll
    for (int rr = 0; rr < kPkRows; ++rr)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) acc[rr][bb] = 0.f;

    for (int sb = sl; sb < nsb; sb += lpr) {
      Step st;
      load_step<Q3>(st, p, rw, sb, n);
      if (!waited) {                             // the pre-pass's terms from here on
        asm volatile("griddepcontrol.wait;" ::: "memory");
        waited = true;
      }
      float part[kPkRows][NB], pmin[kPkRows][NB];
#pragma unroll
      for (int rr = 0; rr < kPkRows; ++rr)
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) part[rr][bb] = pmin[rr][bb] = 0.f;
      XTerms<NB> xt;
      load_x<NB, EXPERTS>(xt, terms, aux, b, 0, sb, nsb);
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {           // groups 16 sb + 4 qd .. + 3
        uint32_t t[kPkRows][4], hb[kPkRows][4];
#pragma unroll
        for (int rr = 0; rr < kPkRows; ++rr) {
          transpose4(word(st.q[rr][0], qd), word(st.q[rr][1], qd), word(st.q[rr][2], qd),
                     word(st.q[rr][3], qd), t[rr]);
          if constexpr (Q3) high_bits(word(st.h[rr][0], qd), word(st.h[rr][1], qd), hb[rr]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * qd + k;
          const XTerms<NB> cur = xt;
          if (j < 15) load_x<NB, EXPERTS>(xt, terms, aux, b, j + 1, sb, nsb);
          uint32_t u[kPkRows][4];
          int scv[kPkRows];
          float mnf[kPkRows];
#pragma unroll
          for (int rr = 0; rr < kPkRows; ++rr) {
            unpack<Q3>(t[rr][k], Q3 ? hb[rr][k] : 0u, u[rr]);
            const uint32_t sw = word(st.sc[rr], qd);
            if constexpr (Q3) {
              scv[rr] = (int)(int8_t)(uint8_t)(sw >> (8 * k));   // the signed scale
            } else {
              scv[rr] = (int)((sw >> (8 * k)) & 0xFu);
              mnf[rr] = (float)((sw >> (8 * k + 4)) & 0xFu);
            }
          }
#pragma unroll
          for (int bb = 0; bb < NB; ++bb) {
            const uint4 xa = cur.a[bb], xb = cur.b[bb];
            const float2 ax = cur.s[bb];
            const int init = Q3 ? __float_as_int(ax.y) : 0;
#pragma unroll
            for (int rr = 0; rr < kPkRows; ++rr) {
              int sa = __dp4a((int)xa.x, (int)u[rr][0], 0);
              int sbv = __dp4a((int)xb.x, (int)u[rr][0], init);
              sa = __dp4a((int)xa.y, (int)u[rr][1], sa);
              sbv = __dp4a((int)xb.y, (int)u[rr][1], sbv);
              sa = __dp4a((int)xa.z, (int)u[rr][2], sa);
              sbv = __dp4a((int)xb.z, (int)u[rr][2], sbv);
              sa = __dp4a((int)xa.w, (int)u[rr][3], sa);
              sbv = __dp4a((int)xb.w, (int)u[rr][3], sbv);
              const int c = sa * 254 + sbv;      // exact: |c| < 2^22
              part[rr][bb] = fmaf(ax.x, (float)(scv[rr] * c), part[rr][bb]);
              if constexpr (!Q3) pmin[rr][bb] = fmaf(mnf[rr], ax.y, pmin[rr][bb]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kPkRows; ++rr)
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          acc[rr][bb] = fmaf(st.dv[rr], part[rr][bb], acc[rr][bb]);
          if constexpr (!Q3) acc[rr][bb] = fmaf(-st.mv[rr], pmin[rr][bb], acc[rr][bb]);
        }
    }

#pragma unroll
    for (int rr = 0; rr < kPkRows; ++rr)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
        for (int m = lpr >> 1; m > 0; m >>= 1)
          acc[rr][bb] += __shfl_xor_sync(0xffffffffu, acc[rr][bb], m);
    if (sl == 0) {
#pragma unroll
      for (int rr = 0; rr < kPkRows; ++rr) {
        const int r = row0 + rr;
        if (r < d) {
#pragma unroll
          for (int bb = 0; bb < NB; ++bb)
            y[(size_t)(EXPERTS ? b : bb) * d + r] = acc[rr][bb];
        }
      }
    }
  }
}

struct Args {
  const uint4* terms;
  const float2* aux;
  Planes p;
  const void* idx;
  int idx64;
  float* y;
  int pairs, d, n, lpr_shift, blocks;
};

// the matvec behind the pre-pass, allowed to start before the pre-pass ends
template <bool Q3, int NB, bool EXPERTS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return launch_behind(packed_mv_kernel<Q3, NB, EXPERTS>, a.blocks, kPkThreads, stream, a.terms,
                       a.aux, a.p, a.idx, a.idx64, a.y, a.pairs, a.d, a.n, a.lpr_shift);
}

template <bool Q3>
cudaError_t dispatch(const Args& a, int rows_x, cudaStream_t stream) {
  if (a.idx != nullptr) return launch<Q3, 1, true>(a, stream);
  switch (rows_x) {
    case 1: return launch<Q3, 1, false>(a, stream);
    case 2: return launch<Q3, 2, false>(a, stream);
    case 3: return launch<Q3, 3, false>(a, stream);
    case 4: return launch<Q3, 4, false>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (rows_x, d) f32 = packed matvec of x (rows_x, n) in dtype x_dtype (0
// f32, 1 f16, 2 bf16), natural column order. kind 0 = Q2_K: qs (E, d, n/4) u8, s8 = sm (E, d, n/16) u8, dsup
// and dmin (E, d, n/256) f32, hm null; kind 1 = Q3_K: qs, hm (E, d, n/8)
// u8, s8 = sc (E, d, n/16) int8, dsup, dmin null. idx (rows_x,) of
// idx_bytes 4 (int32) or 8 (int64) selects the expert of each row (K2), or
// is null with E = 1 and rows_x <= kPkMaxX (K5). scratch: rows_x * n/16 *
// 40 bytes, 16-byte aligned (the pre-pass's terms, then its group scalars).
// lanes: lanes a row (a power of two up to 32), warps: the persistent
// warps (ops/kernels/qmm.py::packed_lanes, packed_warps). Needs n % 256 ==
// 0 and 16-byte aligned planes. Returns a cudaError_t; the two launches are
// asynchronous on `stream`.
extern "C" int packed_mv(const void* x, int x_dtype, int kind, const void* qs, const void* hm,
                         const void* s8, const void* dsup, const void* dmin,
                         const void* idx, int idx_bytes, void* scratch, void* y,
                         int rows_x, int d, int n, int lanes, int warps, void* stream) {
  if (rows_x <= 0 || d <= 0 || n <= 0 || n % 256 != 0 || warps <= 0 || x_dtype < 0 ||
      x_dtype > 2 || lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      kind < 0 || kind > 1 || x == nullptr || qs == nullptr || s8 == nullptr ||
      dsup == nullptr || scratch == nullptr || y == nullptr ||
      (kind == 0 && dmin == nullptr) || (kind == 1 && hm == nullptr) ||
      (idx == nullptr && rows_x > kPkMaxX) ||
      (idx != nullptr && idx_bytes != 4 && idx_bytes != 8) ||
      (long long)rows_x * (n / 16) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int groups = rows_x * (n / 16);
  auto terms = static_cast<uint4*>(scratch);
  auto aux = reinterpret_cast<float2*>(terms + 2 * (size_t)groups);
  // Q3_K's -4 as the integer start; Q2_K's min term against the f32 sum
  cudaError_t err = launch_xsplit(x, x_dtype, 0, terms, aux, groups, n, 4, kind == 0, st);
  if (err != cudaSuccess) return (int)err;
  const Args a{terms, aux,
               Planes{static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(hm),
                      static_cast<const uint8_t*>(s8), static_cast<const float*>(dsup),
                      static_cast<const float*>(dmin)},
               idx, idx_bytes == 8 ? 1 : 0, static_cast<float*>(y), rows_x, d, n,
               __builtin_ctz(lanes), (warps + kPkThreads / 32 - 1) / (kPkThreads / 32)};
  err = kind == 1 ? dispatch<true>(a, rows_x, st) : dispatch<false>(a, rows_x, st);
  return (int)err;
}
