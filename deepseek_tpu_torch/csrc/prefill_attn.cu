// Flash attention on Hopper's tensor cores (sm_90a): chunked causal
// prefill, and absorbed-MLA decode as the same kernel with one query.
//
// Replaces the TPU kernels deepseek_tpu/ops/pallas/attention.py:481
// mha_prefill_attn (_mha_prefill_body, pallas_call :543; K9: the
// decompressed heads of the hybrid-MLA prefill), :644 mla_prefill_attn
// (_mla_prefill_body, pallas_call :707; K10: the absorbed prefill over the
// latent cache) and :170 mla_decode_attn (_mla_body :89, pallas_call :221;
// K3: absorbed-MLA decode). For query t of the chunk at position q_pos0 + t
// and cache slot s holding position cache_pos0 + s:
//
//   s_ts = scale * q_t . k_s,   masked unless cache_pos0 + s <= q_pos0 + t
//   out_t = sum_s softmax(s_t)_s v_s                      (float32)
//
//   K9  (MHA): q (B,T,H,Dh) f32, k (B,S,H,Dh), v (B,S,H,Dv)
//   K10 (MQA): q = [q_c | q_rope] (B,T,H,R+P) f32, k = [ckv | krope]
//              (B,S,R+P), v = ckv (B,S,R): one cache row serves every head
//   K3  (MQA decode, Args::kv_len set): K10 with T = 1, so the block's 64
//              rows are 64 heads of one sequence, and slot s masked unless
//              s < kv_len[b], read on the device (no host position)
//
// Bound: operations (V3, T 256 at 3840, S 4096, H 128: K9 ~83 GFLOP, K10
// ~283 GFLOP over a few MB of cache). K3 at V3's 128 heads over 4000 slots:
// ~1.1 GFLOP over 4.6 MB of bf16 cache, ~1.4 us of bytes and ~2.3 us of
// split-operand MMA at the card's peaks; at B = 1 its two row blocks walk
// the window in many spans (mla_decode_splits in ops/kernels/attention.py,
// one block an SM), which makes the per-block costs (the 147 KB of queries
// staged, the 131 KB of partials written and merged) the ones to watch.
//
// The function is the f32 one (the port's oracle; every check holds the
// kernel at 1e-4 of max|ref|), computed on the tensor cores (wgmma, bf16
// operands, f32 accumulators) with split operands:
//  - the f32 operand of each product (q, the probabilities p) is split as
//    hi = bf16(x), lo = bf16(x - hi): x - (hi + lo) is within 2^-18 |x|;
//  - the cache operand is exact in one bf16 term for bf16 and int8 caches
//    (|v| <= 127) and takes two (hi, lo) for f16 (exact) and f32 ones;
//  - each product is hi.k + lo.k (+ hi.k_lo for two-term caches), so the
//    MMA work is twice single-pass bf16's (three times for f16/f32), and
//    the attainable floor about twice the bf16 flop bound. Single-pass
//    bf16, the TPU's DEFAULT precision, misses 1e-4 at DeepSeek's score
//    range (tests/test_torch_prefill_tc.py).
// int8 rows go to bf16 exactly and their f32 row scales fold in after the
// products, as the TPU kernel does (:449-458, :613): K9 scales score
// column s by ks[b,h,s] and p column s by vs[b,h,s] before P.V; K10 keeps
// the latent and rope scores apart and takes sc * ckvs + sr * krs, and
// scales p by ckvs.
//
// A block owns 64 query rows (K9: 64 consecutive queries of one head,
// grid H x ceil(T/64); K10: 64 consecutive (t, h) pairs of the row-major
// (T, H) order, all heads of a position together, so K and V are shared
// by all its rows) and walks its cache slots in tiles of TS = 32 (16 for
// K10 over f16/f32 rows, for shared memory) with the online softmax in
// registers (quad shuffles on the accumulator fragments, exp2). One warp
// group (4 warps) issues the products for the 64 rows:
// scores S = Q K^T with Q and K from shared memory (wgmma m64n32k16), then
// P V with p from registers (the score fragments of two 8-slot n-tiles are
// the A fragment of one 16-slot k-step; wgmma m64nDVk16, V MN-major). At
// DV = 512 the 64 x 512 f32 accumulator does not fit one group's
// registers: a second group takes the other 256 value columns and half of
// the score columns (half of the latent and half of the rope ones, so that
// both groups issue the same wgmma sequence: a thread-dependent loop count
// serializes the wgmmas, ptxas C7520), and the two warps of each row pair
// sum their partial scores through shared memory (two pair barriers).
// Queries and cache tiles live in shared memory in the wgmma canonical
// 128-byte-swizzled layout (64-column blocks of 8-row x 128-byte atoms; the
// q hi and lo blocks interleaved); key columns past DK up to a multiple of
// 64 are zero. Shared memory bounds the design: K10's q hi/lo take 147,456
// bytes, the two 32-slot stages 73,728. The queries' f32 rows come by
// cp.async, all in flight at once, into their tiles' own space (a 64-column
// f32 slab where its hi and lo blocks go), and are split slab by slab in
// place while the first cache tiles land.
//
// Staging: bf16 cache tiles come by TMA (cp.async.bulk.tensor, 2-D maps
// with 64-column 128-byte-swizzled boxes, encoded on the host through
// cudaGetDriverEntryPoint: no libcuda link) into a 2-stage ring with an
// mbarrier a stage, so tile i+1 loads while tile i multiplies; value rows
// past the block's range are zeroed in the last tile. int8, f16 and f32
// tiles come by TMA as raw column blocks into two raw stages (one for K10
// over f32 rows: shared memory) and are widened, 16 bytes a load, into the
// operand tile (int8) or its hi and lo terms (f16, f32), rows past the
// range as zeros. Only a cache TMA cannot take (a base, row stride or
// box width off 16 bytes; K9's bf16 keys at Dh % 64) comes by cp.async,
// zero-filled past the range; a launch whose maps the driver cannot encode
// fails, and never falls back to cp.async. Tiles past the block's last
// visible slot are not walked; only tiles that cross the causal diagonal
// or the range's end are masked.
//
// Few blocks (V2-Lite's K9: 16 heads x 4 row blocks = 64 blocks on 132
// SMs; K3 always): the wrapper splits the window into n_split spans of
// `span` slots (a pure function of the shapes, ops/kernels/prefill_attn.py
// and ops/kernels/attention.py); each split writes the partials triple into
// scratch and a merge kernel combines them, dividing for the normal output
// or not for partials. A split block that sees no slot (a span past the
// live prefix: short decode windows) writes only m = -1e30 and l = 0 for
// its rows and returns before staging its queries; the merge skips the
// splits with l = 0 and never reads their accumulators.
//
// Partials (partials=True, context-parallel prefill: one shard of the
// window per rank, its slot s at global position cache_pos0 + s): the
// rows' unnormalized accumulator and flash statistics, m (the row's
// running maximum of the scaled scores) and l = sum exp(s - m) laid out
// (B,T,H), the TPU kernel's partials output after its swapaxes. A row that
// sees no slot keeps acc 0, l 0 and m = -1e30 (the JAX _NEG_INF).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxSplits = 16;   // window splits of a prefill launch
                                 // (_MAX_SPLITS in ops/kernels/prefill_attn.py)
constexpr int kMaxDecodeSplits = 128;  // of a decode launch, and the most the
                                       // merge takes (_MAX_DECODE_SPLITS in
                                       // ops/kernels/attention.py)
constexpr int kMergeThreads = 512;   // a multiple of DV / 4 for DV 128, 512
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int ch, bool valid) {
  const int n = valid ? ch : 0;   // 0 source bytes: zero-fill
  switch (ch) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(dst), "l"(src), "r"(n));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(dst), "l"(src), "r"(n));
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(dst), "l"(src), "r"(n));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Args {
  const float* q;    // K9: q (B,T,H,DK); K10: q_c (B,T,H,DV)
  const float* qr;   // K10: q_rope (B,T,H,DK-DV); K9: unused
  const void* k;     // K9: k (B,S,H,DK); K10: ckv (B,S,DV)
  const void* v;     // K9: v (B,S,H,DV); K10: krope (B,S,DK-DV)
  float* out;        // (n_split,B,T,H,DV): the output or the split partials
  float* m_out;      // (n_split,B,T,H) row maxima, null for normalized output
  float* l_out;      // (n_split,B,T,H) sums of exp(s - m)
  int B, T, H, S, DK;
  int q_pos0, cache_pos0;
  float scale;
  int span;          // slots per window split (split z walks [z*span, ...))
  int ch0, ch1;      // cp.async bytes for the two cache segments (16/8/4)
  int tma;           // the tiles by TMA (Maps): bit 0 K (and, but for a bf16
                     // K10, V), bit 1 a bf16 K10's rope rows; 0: cp.async
  // int8 caches: the f32 scales of the k and v rows (K10: ckv and krope),
  // element (b, h, s) at b * sb + h * sh + s * ss (K10: sh = 0)
  const float* ks;
  const float* vs;
  int sb, sh, ss;
  // decode (K3, T = 1): kv_len (B,) int32 on the device, slot s live while
  // s < kv_len[b]; q_pos0 and cache_pos0 unused. Null for prefill.
  const int32_t* kv_len;
};

// TMA tensor maps of the cache, 2-D (columns, B*S rows) with boxes of TS
// rows: over a bf16 cache 64 columns, 128-byte swizzled, exactly one
// column block of an operand tile; over int8, f16 and f32 ones a raw
// column block (raw_cw). K10: k = ckv, v = krope; K9: k and v over all
// heads' columns (H*DK, H*DV).
struct alignas(64) Maps {
  CUtensorMap k, v;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// the tile shapes of one instantiation
template <bool MQA, typename KT, int DV>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<KT, __nv_bfloat16>::value;
  static constexpr bool kQ8 = std::is_same<KT, int8_t>::value;
  static constexpr bool kSplit = std::is_same<KT, float>::value ||
                                 std::is_same<KT, __half>::value;
  static constexpr int NG = DV > 256 ? 2 : 1;      // warp groups
  static constexpr int WM = 4;                     // warps along the rows
  static constexpr int BM = 16 * WM;               // query rows: one wgmma M
                                                   // (_BLOCK_ROWS in the wrapper)
  static constexpr int kThreads = 32 * WM * NG;
  static constexpr int TS = (NG == 2 && kSplit) ? 16 : 32;  // slots a tile
  static constexpr int NT = TS / 8;                // score n-tiles
  static constexpr int DVW = DV / NG;              // value columns a warp
  static constexpr int NA = DVW / 8;               // accumulator n-tiles
  static constexpr int NST = kBf16 ? 2 : 1;        // operand ring stages
  // raw stages (non-bf16): two, one for K10 over f32 rows (shared memory)
  static constexpr int NSTR = (NG == 2 && sizeof(KT) == 4) ? 1 : 2;
  static_assert(NST <= 2 && NSTR <= 2, "one TMA barrier a stage, two stages");
  static constexpr int XW = TS + 4;                // score exchange pitch
};

// shared memory layout (byte offsets), the same on host and device
struct Layout {
  int q_hi, q_lo;    // [BM][DKP] bf16, swizzled, interleaved by 64-column
                     // block (hi block k at q_hi + k * 2 * BM * 128, lo
                     // block k BM * 128 bytes after it)
  int op;            // the operand tiles: NST ring stages of `stage` bytes
  int stage;         // (K [TS][DKP], MHA: then V [TS][DV]), bf16 swizzled
  int op_lo;         // f16/f32 caches: the lo terms of op[0]
  int raw;           // non-bf16 caches: NSTR raw stages of `rstage` bytes,
  int rstage;        // segment 0 then 1 (at raw1), each [E/cw][TS][cw]
  int raw1;          // of its E elements, cw = min(E, 256)
  int xch;           // NG = 2: [BM][XW] f32 partial scores
  int scl;           // int8: [2][TS] f32 slot scales
  int total;
};

template <bool MQA, typename KT, int DV>
__host__ __device__ Layout layout(int DK) {
  using C = Cfg<MQA, KT, DV>;
  const int DKP = round_up(DK, 64);
  const int stage = C::TS * DKP * 2 + (MQA ? 0 : C::TS * DV * 2);
  Layout L{};
  int o = 0;
  // the operand tiles 1024-aligned (the swizzle atoms)
  auto take = [&](int bytes, int align) {
    o = round_up(o, align);
    const int at = o;
    o += bytes;
    return at;
  };
  L.q_hi = take(2 * C::BM * DKP * 2, 1024);
  L.q_lo = L.q_hi + C::BM * 128;
  L.stage = round_up(stage, 1024);
  L.op = take(C::NST * L.stage, 1024);
  L.op_lo = C::kSplit ? take(stage, 1024) : L.op;
  if (!C::kBf16) {
    const int seg0 = C::TS * (MQA ? DV : DK) * (int)sizeof(KT);
    const int seg1 = C::TS * (MQA ? DK - DV : DV) * (int)sizeof(KT);
    L.raw1 = round_up(seg0, 128);
    L.rstage = round_up(L.raw1 + seg1, 128);
    L.raw = take(C::NSTR * L.rstage, 128);
  }
  if (C::NG == 2) L.xch = take(C::BM * C::XW * 4, 128);
  if (C::kQ8) L.scl = take(2 * C::TS * 4, 128);
  L.total = o;
  return L;
}

// One cache segment of a tile: `elems` values of a slot's row at
// src + s * stride (elements of KT), `ch` bytes a cp.async.
struct Seg {
  const char* src;
  long long stride_b;   // bytes between slots
  int row_b;            // bytes of one slot's row
  int ch;
  int cw_b;             // bytes of a raw column block: min(row, 256 elements)
};

// the column block of a raw segment of E elements: 256 where E is a
// larger multiple of 256, else the whole row
__host__ __device__ inline int raw_cw(int E) {
  return E > 256 && E % 256 == 0 ? 256 : E;
}

// byte offset of byte cb of row r in a raw segment of TS rows of row_b
// bytes kept as column blocks of cw_b bytes ([row_b / cw_b][TS][cw_b]: a
// TMA box each)
__device__ __forceinline__ int raw_b(int r, int TS, int cb, int row_b, int cw_b) {
  if (cw_b == row_b) return r * row_b + cb;
  const int sh = __ffs(cw_b) - 1;                // blocked: 256 elements, 2^k bytes
  return (((cb >> sh) * TS + r) << sh) + (cb & (cw_b - 1));
}

// iterate i = start, start + step, ... over [0, rows * per) as (r, c)
// without a division in the loop
struct Walk {
  int r, c, dr, dc, per;
  __device__ Walk(int start, int step, int per_) : per(per_) {
    r = start / per; c = start - r * per;
    dr = step / per; dc = step - dr * per;
  }
  __device__ __forceinline__ void next() {
    r += dr; c += dc;
    if (c >= per) { c -= per; ++r; }
  }
};

// copy slots s0 .. s0 + TS - 1 of a segment into shared memory; slots at
// or past s_hi are zero-filled. Swizzled (an operand tile of TS rows, at
// byte column col_b) or plain (raw rows of row_b bytes).
template <int TS, bool SWZ>
__device__ __forceinline__ void copy_seg(const Seg& g, uint32_t dst, int col_b,
                                         int s0, int s_hi, int tid, int nthr) {
  if (g.row_b == 0) return;
  const int per = g.row_b / g.ch;
  for (Walk w(tid, nthr, per); w.r < TS; w.next()) {
    const int s = s0 + w.r;
    const bool ok = s < s_hi;
    const char* src = g.src + (long long)(ok ? s : s0) * g.stride_b + w.c * g.ch;
    const uint32_t d = SWZ ? dst + tile_b(w.r, TS, col_b + w.c * g.ch)
                           : dst + raw_b(w.r, TS, w.c * g.ch, g.row_b, g.cw_b);
    cp_async(d, src, g.ch, ok);
  }
}

// widen a raw segment ([TS][elems] of KT) into the bf16 operand tile(s)
// of TS rows at column c0: hi, and lo for two-term caches; rows from
// nvalid on (past the range: whatever a TMA box brought) become zeros
template <typename KT, int TS, bool SPLIT>
__device__ __forceinline__ void convert_seg(const char* raw, int elems,
                                            char* hi, char* lo, int c0,
                                            int nvalid, int tid, int nthr) {
  if (elems == 0) return;
  const KT* src = reinterpret_cast<const KT*>(raw);
  const int cw = raw_cw(elems);
  if constexpr (std::is_same<KT, int8_t>::value) {
    if (elems % 16 == 0) {     // 16 values a load, two 16-byte chunks a store
      for (Walk it(tid, nthr, elems / 16); it.r < TS; it.next()) {
        const int c = 16 * it.c;
        int4 v = *reinterpret_cast<const int4*>(src + raw_b(it.r, TS, c, elems, cw));
        if (it.r >= nvalid) v = make_int4(0, 0, 0, 0);
        const int8_t* b8 = reinterpret_cast<const int8_t*>(&v);
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(b8[2 * k], b8[2 * k + 1]);
          o[k] = *reinterpret_cast<const uint32_t*>(&h);
        }
        *reinterpret_cast<uint4*>(hi + tile_e(it.r, TS, c0 + c)) =
            make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(hi + tile_e(it.r, TS, c0 + c + 8)) =
            make_uint4(o[4], o[5], o[6], o[7]);
      }
      return;
    }
  } else if constexpr (SPLIT) {
    // 16 bytes a load (4 f32 or 8 f16 values), their hi and lo terms one
    // store each (8 or 16 bytes: inside one swizzled 16-byte chunk)
    constexpr int VW = 16 / (int)sizeof(KT);
    if (elems % VW == 0) {
      for (Walk it(tid, nthr, elems / VW); it.r < TS; it.next()) {
        const int c = VW * it.c;
        uint4 v = *reinterpret_cast<const uint4*>(src + raw_b(it.r, TS, c, elems, cw));
        if (it.r >= nvalid) v = make_uint4(0u, 0u, 0u, 0u);
        const KT* x = reinterpret_cast<const KT*>(&v);
        uint32_t h[VW / 2], l[VW / 2];
#pragma unroll
        for (int k = 0; k < VW / 2; ++k)
          split2(to_f(x[2 * k]), to_f(x[2 * k + 1]), h[k], l[k]);
        const uint32_t off = tile_e(it.r, TS, c0 + c);
        if constexpr (VW == 8) {
          *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
        } else {
          *reinterpret_cast<uint2*>(hi + off) = make_uint2(h[0], h[1]);
          *reinterpret_cast<uint2*>(lo + off) = make_uint2(l[0], l[1]);
        }
      }
      return;
    }
  }
  const int per = elems / 2;
  for (Walk it(tid, nthr, per); it.r < TS; it.next()) {
    const int c = 2 * it.c;
    const int at = raw_b(it.r, TS, c, elems, cw);   // in elements
    const bool ok = it.r < nvalid;
    const float x0 = ok ? to_f(src[at]) : 0.f;
    const float x1 = ok ? to_f(src[at + 1]) : 0.f;
    const uint32_t off = tile_e(it.r, TS, c0 + c);
    if (SPLIT) {
      uint32_t h, l;
      split2(x0, x1, h, l);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(lo + off) = l;
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
    }
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_ss_n16(d, da, db);
  else wgmma_ss_n32(d, da, db);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// scores of this warp group's 64 rows against the tile's TS slots over
// the n k-steps of 16 columns from k0: q_hi.k + q_lo.k, plus q_hi.k_lo for
// two-term caches. q: 64-column blocks BM rows apart (the interleaved hi
// and lo tiles), the group's rows from r0; k: tiles of TS rows. Issued and
// committed; the caller waits.
template <int TS, int BM, bool SPLIT>
__device__ __forceinline__ void score_steps(float (&c)[TS / 8][4], uint32_t qh,
                                            uint32_t ql, uint32_t kh,
                                            uint32_t kl, int r0, int k0, int n) {
  for (int j = 0; j < n; ++j) {
    const int kk = k0 + 16 * j;
    // column block kk / 64, and 32 bytes a 16-column step inside it
    const uint32_t qo = ((kk >> 6) * BM + r0) * 128 + (kk & 63) * 2;
    const uint32_t ko = (kk >> 6) * TS * 128 + (kk & 63) * 2;
    const uint64_t dk = desc(kh + ko, 16, 1024);
    wgmma_ss<TS>(c, desc(qh + qo, 16, 1024), dk);
    wgmma_ss<TS>(c, desc(ql + qo, 16, 1024), dk);
    if (SPLIT) wgmma_ss<TS>(c, desc(qh + qo, 16, 1024), desc(kl + ko, 16, 1024));
  }
  wg_commit();
}

// acc (this warp group's 64 rows x DVW value columns from col0) += p . V
// over KS k-steps of 16 slots: p_hi.v + p_lo.v, plus p_hi.v_lo for
// two-term caches. V: tiles of TS slot rows, MN-major. Issued and
// committed; the caller waits.
template <int DVW, int KS, int TS, bool SPLIT>
__device__ __forceinline__ void pv_steps(float (&acc)[DVW / 8][4],
                                         const uint32_t (&ph)[KS][4],
                                         const uint32_t (&pl)[KS][4],
                                         uint32_t vh, uint32_t vl, int col0) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t vo = (col0 >> 6) * TS * 128 + ks * 16 * 128;
    const uint64_t dv = desc(vh + vo, TS * 128, 1024);
    wgmma_rs<DVW>(acc, ph[ks], dv);
    wgmma_rs<DVW>(acc, pl[ks], dv);
    if (SPLIT) wgmma_rs<DVW>(acc, ph[ks], desc(vl + vo, TS * 128, 1024));
  }
  wg_commit();
}

template <bool MQA, typename KT, int DV>
__global__ void __launch_bounds__(Cfg<MQA, KT, DV>::kThreads)
prefill_attn_kernel(Args a, const __grid_constant__ Maps maps) {
  using C = Cfg<MQA, KT, DV>;
  constexpr int TS = C::TS, NT = C::NT, NA = C::NA, NG = C::NG;
  constexpr int NTHR = C::kThreads, KS = TS / 16;
  constexpr bool kQ8 = C::kQ8, kSplit = C::kSplit;
  // 1024-aligned (the swizzle atoms): the static barriers before it are
  // padded to 1024 bytes, which the launch's shared memory budget counts
  extern __shared__ __align__(1024) char sm[];
  __shared__ uint64_t bars[2];                   // TMA: one a ring stage
  const int DK = a.DK, DKP = round_up(DK, 64), H = a.H, T = a.T, S = a.S;
  const Layout L = layout<MQA, KT, DV>(DK);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kBM = C::BM;
  const int wm = warp % C::WM, wg = warp / C::WM;   // row slice, warp group
  const int g = lane >> 2, qd = lane & 3;
  const int b = blockIdx.y, z = blockIdx.z;

  // block rows -> (t, h): K10 flattens (t, h); K9 fixes h
  int h_fix = 0, row0;
  if (MQA) {
    row0 = blockIdx.x * kBM;                     // index into T*H
  } else {
    const int ntt = (T + kBM - 1) / kBM;
    h_fix = blockIdx.x / ntt;
    row0 = (blockIdx.x % ntt) * kBM;             // first t
  }
  const int n_rows = MQA ? T * H : T;
  auto row_t = [&](int i) { return MQA ? (row0 + i) / H : row0 + i; };
  // (b, t, h) index of block row i
  auto row_off = [&](int i) -> long long {
    return MQA ? (long long)b * T * H + row0 + i
               : ((long long)b * T + row0 + i) * H + h_fix;
  };

  // this split's slots: [s_lo, s_hi), cut at the last one the block's
  // latest query may see (decode: at the sequence's kv_len). A row sees
  // slot s while s <= lim (lim_first: the block's first row)
  const bool decode = a.kv_len != nullptr;
  const int i_last = min(kBM, n_rows - row0) - 1;
  const int lim_first = decode ? S : a.q_pos0 + row_t(0) - a.cache_pos0;
  const int s_end = max(0, min(S, decode ? a.kv_len[b]
                                         : a.q_pos0 + row_t(i_last) - a.cache_pos0 + 1));
  const int s_lo = z * a.span;
  const int s_hi = min(s_end, s_lo + a.span);
  const int n_tiles = s_hi > s_lo ? (s_hi - s_lo + TS - 1) / TS : 0;
  const long long slab = (long long)a.B * T * H;  // rows of one split
  if (n_tiles == 0 && gridDim.z > 1) {
    // an empty span: l = 0 tells the merge to skip it (and its accumulator)
    for (int i = tid; i < kBM && row0 + i < n_rows; i += NTHR) {
      const long long ro = row_off(i) + z * slab;
      a.m_out[ro] = kNegInf;
      a.l_out[ro] = 0.f;
    }
    return;
  }
  int lim[2];                                    // rows g and g + 8
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = wm * 16 + g + 8 * j;
    lim[j] = row0 + i >= n_rows ? -1 : decode ? S : a.q_pos0 + row_t(i) - a.cache_pos0;
  }

  // the two cache segments of a tile: K9 keys and values of head h_fix;
  // K10 the latent rows and the rope rows
  const KT* kp = static_cast<const KT*>(a.k);
  const KT* vp = static_cast<const KT*>(a.v);
  constexpr int kSz = (int)sizeof(KT);
  Seg sg0, sg1;
  if (MQA) {
    const int P = DK - DV;
    sg0 = {reinterpret_cast<const char*>(kp + (long long)b * S * DV),
           (long long)DV * kSz, DV * kSz, a.ch0, raw_cw(DV) * kSz};
    sg1 = {reinterpret_cast<const char*>(vp + (long long)b * S * P),
           (long long)P * kSz, P * kSz, a.ch1, raw_cw(P) * kSz};
  } else {
    sg0 = {reinterpret_cast<const char*>(kp + ((long long)b * S * H + h_fix) * DK),
           (long long)H * DK * kSz, DK * kSz, a.ch0, raw_cw(DK) * kSz};
    sg1 = {reinterpret_cast<const char*>(vp + ((long long)b * S * H + h_fix) * DV),
           (long long)H * DV * kSz, DV * kSz, a.ch1, raw_cw(DV) * kSz};
  }
  const int vt_off = MQA ? 0 : TS * DKP * 2;    // the V tile in a stage

  // TMA: one thread asks for the K (and K9's V) column blocks of a tile;
  // the stage's barrier counts their bytes in
  // (K10's rope rows too where P is a multiple of 64: a.tma bit 1)
  const int kcb = MQA ? DV / 64 : DKP / 64;
  const int vcb = MQA ? ((a.tma & 2) ? (DK - DV) / 64 : 0) : DV / 64;
  const uint32_t tma_bytes = (kcb + vcb) * TS * 128;
  auto issue = [&](int i) {
    const int s0 = s_lo + i * TS;
    if (C::kBf16) {
      const uint32_t base = smem_addr(sm + L.op + (i % C::NST) * L.stage);
      if (a.tma) {
        if (tid == 0) {
          const uint32_t bar = smem_addr(&bars[i % C::NST]);
          const int row = b * S + s0;
          mbar_expect(bar, tma_bytes);
          for (int cb = 0; cb < kcb; ++cb)
            tma_2d(base + cb * TS * 128, &maps.k, (MQA ? 0 : h_fix * DK) + cb * 64,
                   row, bar);
          for (int cb = 0; cb < vcb; ++cb)
            tma_2d(base + (MQA ? kcb * TS * 128 : vt_off) + cb * TS * 128, &maps.v,
                   (MQA ? 0 : h_fix * DV) + cb * 64, row, bar);
        }
        if (MQA && !(a.tma & 2))
          copy_seg<TS, true>(sg1, base, DV * 2, s0, s_hi, tid, NTHR);
      } else {
        copy_seg<TS, true>(sg0, base, 0, s0, s_hi, tid, NTHR);
        copy_seg<TS, true>(sg1, base + vt_off, MQA ? DV * 2 : 0, s0, s_hi, tid, NTHR);
      }
    } else {
      const uint32_t base = smem_addr(sm + L.raw + (i % C::NSTR) * L.rstage);
      if (a.tma) {             // raw column blocks by TMA (cb in bytes)
        if (tid == 0) {
          const uint32_t bar = smem_addr(&bars[i % C::NSTR]);
          const int row = b * S + s0;
          mbar_expect(bar, TS * (sg0.row_b + sg1.row_b));
          for (int cb = 0; cb < sg0.row_b; cb += sg0.cw_b)
            tma_2d(base + cb * TS, &maps.k, (MQA ? 0 : h_fix * DK) + cb / kSz, row, bar);
          for (int cb = 0; cb < sg1.row_b; cb += sg1.cw_b)
            tma_2d(base + L.raw1 + cb * TS, &maps.v, (MQA ? 0 : h_fix * DV) + cb / kSz,
                   row, bar);
        }
      } else {
        copy_seg<TS, false>(sg0, base, 0, s0, s_hi, tid, NTHR);
        copy_seg<TS, false>(sg1, base + L.raw1, 0, s0, s_hi, tid, NTHR);
      }
    }
    cp_commit();
  };

  // non-bf16 caches: the landed raw stage -> bf16 operand tile(s), and the
  // int8 slot scales (0 past the range)
  float* scl = reinterpret_cast<float*>(sm + L.scl);
  auto convert = [&](int i, int s0) {
    char* hi = sm + L.op;
    char* lo = sm + L.op_lo;
    const char* raw = sm + L.raw + (i % C::NSTR) * L.rstage;
    const int nvalid = s_hi - s0;
    convert_seg<KT, TS, kSplit>(raw, MQA ? DV : DK, hi, lo, 0, nvalid, tid, NTHR);
    convert_seg<KT, TS, kSplit>(raw + L.raw1, MQA ? DK - DV : DV, hi + vt_off,
                                lo + vt_off, MQA ? DV : 0, nvalid, tid, NTHR);
    if (kQ8 && tid < TS) {
      const int s = s0 + tid;
      const bool ok = s < s_hi;
      const long long sb = (long long)b * a.sb + (long long)h_fix * a.sh;
      scl[tid] = ok ? a.ks[sb + (long long)s * a.ss] : 0.f;
      scl[TS + tid] = ok ? a.vs[sb + (long long)s * a.ss] : 0.f;
    }
  };

  float acc[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const uint32_t qh_a = smem_addr(sm + L.q_hi), ql_a = smem_addr(sm + L.q_lo);
  const int r0 = (warp >> 2) % (C::WM / 4) * 64;  // this warp group's rows
  // the score k-steps of this warp group: all of them, or (NG = 2) half
  // of the latent (K10: key, K9) columns and half of the rope columns, the
  // two halves summed through shared memory. Both groups issue the same
  // number of steps from another column, so no control flow around the
  // wgmmas depends on the thread (ptxas serializes the wgmmas of a
  // divergent path: C7520). Over an int8 latent cache K10 keeps the latent
  // and rope parts apart for their scales.
  const int k_main = MQA ? DV : DKP, k_rest = DKP - k_main;
  const int n_main = k_main / (16 * NG), n_rest = k_rest / (16 * NG);
  const int kb_main = wg * (k_main / NG), kb_rest = k_main + wg * (k_rest / NG);
  constexpr bool kRope = MQA && kQ8;
  float* xb = reinterpret_cast<float*>(sm + L.xch) + wm * 16 * C::XW;

  // the ring: tile j goes to stage j % NST; one commit group a tile
  if (a.tma) {
    if (tid == 0) {
      for (int k = 0; k < 2; ++k) mbar_init(smem_addr(&bars[k]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // the ring: tile j goes to stage j % (NST or NSTR); one commit group a
  // tile (cp.async), one barrier phase a tile (TMA)
  for (int j = 0; j < (C::kBf16 ? C::NST - 1 : C::NSTR); ++j) {
    if (j < n_tiles) issue(j);
    else cp_commit();
  }

  // while the first tiles land: stage the queries as hi/lo bf16. Their f32
  // rows come by cp.async, every copy in flight at once, into the query
  // tiles' own space: 64-column slab k (64 rows x 256 bytes) exactly where
  // hi block k and lo block k go. Then slab by slab each thread reads its
  // values, the block syncs, and it writes their hi and lo terms over them.
  // Rows past the end and columns past DK: zero-filled copies.
  {
    char* qs = sm + L.q_hi;
    const int P = DK - DV;
    for (Walk w(tid, NTHR, DKP / 4); w.r < kBM; w.next()) {
      const int c = 4 * w.c;
      const bool ok = row0 + w.r < n_rows && c < DK;
      const long long ro = row_off(ok ? w.r : 0);
      const float* src = !ok ? a.q
                         : !MQA ? a.q + ro * DK + c
                         : c < DV ? a.q + ro * DV + c : a.qr + ro * P + (c - DV);
      cp_async(smem_addr(qs + (c >> 6) * (2 * kBM * 128) + w.r * 256 + (c & 63) * 4), src,
               16, ok);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    constexpr int kPer = kBM * 16 / NTHR;          // float4s of a slab a thread
    for (int k = 0; k < DKP / 64; ++k) {
      char* slab = qs + k * (2 * kBM * 128);
      float4 x[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        x[u] = reinterpret_cast<const float4*>(slab)[tid + u * NTHR];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = tid + u * NTHR, r = j >> 4, c = (j & 15) * 4;
        uint32_t h0, l0, h1, l1;
        split2(x[u].x, x[u].y, h0, l0);
        split2(x[u].z, x[u].w, h1, l1);
        const uint32_t off = tile_e(r, 2 * kBM, 64 * k + c);
        *reinterpret_cast<uint2*>(sm + L.q_hi + off) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(sm + L.q_lo + off) = make_uint2(l0, l1);
      }
    }
    // key columns past DK are zero in every operand tile (no copy writes them)
    if (DKP > DK) {
      for (Walk w(tid, NTHR, (DKP - DK) / 2); w.r < TS; w.next()) {
        const uint32_t off = tile_e(w.r, TS, DK + 2 * w.c);
#pragma unroll
        for (int k = 0; k < C::NST; ++k)
          *reinterpret_cast<uint32_t*>(sm + L.op + k * L.stage + off) = 0u;
        *reinterpret_cast<uint32_t*>(sm + L.op_lo + off) = 0u;
      }
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s0 = s_lo + i * TS;
    const char* khi;
    const char* klo;
    if constexpr (C::kBf16) {
      cp_wait<C::NST - 2>();
      khi = klo = sm + L.op + (i % C::NST) * L.stage;
      if (a.tma) {
        mbar_wait(smem_addr(&bars[i % C::NST]), (i / C::NST) & 1);
        // TMA brings whole boxes: value rows past the range become zero
        // (masked slots weigh 0, and 0 x a non-finite value is not 0)
        const int nv = s0 + TS - s_hi;
        if (nv > 0) {
          char* vt = const_cast<char*>(khi) + vt_off;
          for (Walk w(tid, NTHR, DV / 8); w.r < nv; w.next())
            *reinterpret_cast<uint4*>(vt + tile_e(TS - nv + w.r, TS, 8 * w.c)) =
                make_uint4(0u, 0u, 0u, 0u);
        }
      }
      proxy_fence();
      // tile i has landed for every thread, and every warp is done with
      // tile i - 1: its stage takes tile i + 1
      __syncthreads();
      if (i + 1 < n_tiles) issue(i + 1);
      else cp_commit();
    } else {
      cp_wait<C::NSTR - 1>();
      if (a.tma) mbar_wait(smem_addr(&bars[i % C::NSTR]), (i / C::NSTR) & 1);
      // tile i's raw rows have landed, every warp is done with the operand
      // tile: widen tile i into it, then its raw stage takes tile i + NSTR
      __syncthreads();
      convert(i, s0);
      proxy_fence();
      __syncthreads();
      const int j = i + C::NSTR;
      if (j < n_tiles) issue(j);
      else cp_commit();
      khi = sm + L.op;
      klo = sm + L.op_lo;
    }
    const uint32_t kh_a = smem_addr(khi), kl_a = smem_addr(klo);

    float sc[NT][4], sr[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sr[j][e] = 0.f;
    pin(sc);
    pin(sr);
    wg_fence();
    score_steps<TS, 2 * kBM, kSplit>(sc, qh_a, ql_a, kh_a, kl_a, r0, kb_main, n_main);
    if constexpr (kRope)
      score_steps<TS, 2 * kBM, kSplit>(sr, qh_a, ql_a, kh_a, kl_a, r0, kb_rest, n_rest);
    else if constexpr (MQA)
      score_steps<TS, 2 * kBM, kSplit>(sc, qh_a, ql_a, kh_a, kl_a, r0, kb_rest, n_rest);
    wg_wait();
    pin(sc);
    pin(sr);

#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = 8 * j + 2 * qd + (e & 1);
        float x = sc[j][e];
        if (kRope)
          x = fmaf(x, scl[sl], sr[j][e] * scl[TS + sl]);
        else if (kQ8)
          x *= scl[sl];
        sc[j][e] = x * a.scale;
      }
    if (NG == 2) {
      // the pair of warps with the same rows: group 1 hands its half over,
      // group 0 adds and hands the sums back
      float2* x2 = reinterpret_cast<float2*>(xb);
      const int pair = 1 + wm;
      const int o0 = (g * C::XW + 2 * qd) / 2, o1 = ((g + 8) * C::XW + 2 * qd) / 2;
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          x2[o0 + 4 * j] = make_float2(sc[j][0], sc[j][1]);
          x2[o1 + 4 * j] = make_float2(sc[j][2], sc[j][3]);
        }
      }
      asm volatile("bar.sync %0, 64;\n" :: "r"(pair));
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 u = x2[o0 + 4 * j], w = x2[o1 + 4 * j];
          sc[j][0] += u.x; sc[j][1] += u.y; sc[j][2] += w.x; sc[j][3] += w.y;
          x2[o0 + 4 * j] = make_float2(sc[j][0], sc[j][1]);
          x2[o1 + 4 * j] = make_float2(sc[j][2], sc[j][3]);
        }
      }
      asm volatile("bar.sync %0, 64;\n" :: "r"(pair));
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 u = x2[o0 + 4 * j], w = x2[o1 + 4 * j];
          sc[j][0] = u.x; sc[j][1] = u.y; sc[j][2] = w.x; sc[j][3] = w.y;
        }
      }
    }

    // mask, row maxima over the quad
    const bool full = s0 + TS <= s_hi && s0 + TS - 1 <= lim_first;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + 8 * j + 2 * qd + (e & 1);
        const bool ok = full || (s < s_hi && s <= lim[e >> 1]);
        const float x = ok ? sc[j][e] : kNegInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float mn = fmaxf(m_r[j], quad_max(mx[j]));
      alpha[j] = exp2f((m_r[j] - mn) * kLog2e);
      m_r[j] = mn;
    }

    // p = exp(s - m), its row sums, and p (times the int8 value scale)
    // split into bf16 hi/lo A fragments of P.V: the C fragments of two
    // score n-tiles are the A fragment of one 16-slot k-step
    uint32_t ph[KS][4], pl[KS][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float x = sc[j][2 * hf + u];
          p[u] = x > kNegInf ? exp2f((x - m_r[hf]) * kLog2e) : 0.f;
          ps[hf] += p[u];
          if (kQ8) p[u] *= scl[(MQA ? 0 : TS) + 8 * j + 2 * qd + u];
        }
        split2(p[0], p[1], ph[j / 2][2 * (j & 1) + hf], pl[j / 2][2 * (j & 1) + hf]);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) l_r[j] = l_r[j] * alpha[j] + ps[j];
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    pin(acc);
    wg_fence();
    pv_steps<C::DVW, KS, TS, kSplit>(acc, ph, pl, kh_a + vt_off, kl_a + vt_off,
                                     wg * C::DVW);
    wg_wait();
    pin(acc);
  }

  // l over the quad; store acc / l, or the partials triple (normalized
  // output: m_out null). Both groups hold the same m and l.
#pragma unroll
  for (int j = 0; j < 2; ++j) l_r[j] = quad_sum(l_r[j]);
  const bool norm = a.m_out == nullptr;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = wm * 16 + g + 8 * hf;
    if (row0 + i >= n_rows) continue;
    const long long ro = row_off(i) + z * slab;
    // fully masked rows have l == 0 and acc == 0
    const float inv = norm ? 1.f / fmaxf(l_r[hf], 1e-30f) : 1.f;
    float* o = a.out + ro * DV + wg * C::DVW + 2 * qd;
#pragma unroll
    for (int n = 0; n < NA; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * hf] * inv, acc[n][2 * hf + 1] * inv);
    if (!norm && wg == 0 && qd == 0) {
      a.m_out[ro] = m_r[hf];
      a.l_out[ro] = l_r[hf];
    }
  }
}

// one block per (b, t, h) row: the exact merge of the window splits'
// partials (acc, m, l) (n_split, rows, ...): out = sum_k w_k acc_k / L with
// w_k = exp(m_k - M), M = max_k m_k, L = sum_k w_k l_k over the splits that
// saw a slot (l_k > 0; the others may have written no accumulator); with
// m_out the unnormalized triple (acc, M, L). If every split is empty: M =
// -1e30, L = 0, acc = 0. The first warp lists the live splits and their
// weights in shared memory; then kMergeThreads / (DV / 4) groups of DV / 4
// threads (a float4 column each) take every group-th live split, so that
// many loads are in flight, and sum their columns through shared memory.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
             const float* __restrict__ l, float* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ l_out, long long rows,
             int DV, int n_split) {
  __shared__ float w_s[kMaxDecodeSplits];
  __shared__ int id_s[kMaxDecodeSplits];
  __shared__ float4 part_s[kMergeThreads];
  __shared__ float stat_s[2];
  __shared__ int n_s;
  const long long row = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = kNegInf;
    for (int k = lane; k < n_split; k += 32)
      if (l[k * rows + row] > 0.f) M = fmaxf(M, m[k * rows + row]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, s));
    float Lsum = 0.f;
    int n = 0;
    for (int k0 = 0; k0 < n_split; k0 += 32) {
      const int k = k0 + lane;
      const float lk = k < n_split ? l[k * rows + row] : 0.f;
      const bool live = lk > 0.f;
      const float e = live ? __expf(m[k * rows + row] - M) : 0.f;
      Lsum += e * lk;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
        id_s[at] = k;
        w_s[at] = e;
      }
      n += __popc(mask);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) Lsum += __shfl_xor_sync(0xffffffffu, Lsum, s);
    if (lane == 0) {
      n_s = n;
      stat_s[0] = M;
      stat_s[1] = Lsum;
    }
  }
  __syncthreads();
  const int n = n_s, cols = DV / 4, groups = kMergeThreads / cols;
  const int grp = threadIdx.x / cols, c = (threadIdx.x - grp * cols) * 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
  for (int j = grp; j < n; j += groups) {
    const float w = w_s[j];
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        acc + ((long long)id_s[j] * rows + row) * DV + c));
    s.x += w * v.x;
    s.y += w * v.y;
    s.z += w * v.z;
    s.w += w * v.w;
  }
  part_s[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < groups; ++g) {
      const float4 u = part_s[g * cols + threadIdx.x];
      s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
    }
    const float inv = m_out != nullptr ? 1.f : 1.f / fmaxf(stat_s[1], 1e-30f);
    s.x *= inv; s.y *= inv; s.z *= inv; s.w *= inv;
    *reinterpret_cast<float4*>(out + row * DV + c) = s;
  }
  if (m_out != nullptr && threadIdx.x == 0) {
    m_out[row] = stat_s[0];
    l_out[row] = stat_s[1];
  }
}

// the widest cp.async (16, 8 or 4 bytes) that keeps a segment's source
// aligned: its base, its row length and its slot stride
int chunk_bytes(const void* base, long long row_b, long long stride_b) {
  const unsigned long long p = reinterpret_cast<unsigned long long>(base);
  for (int ch = 16; ch > 4; ch >>= 1)
    if (p % ch == 0 && row_b % ch == 0 && stride_b % ch == 0) return ch;
  return 4;
}

// both maps, or neither (kNoMap: the tiles come by cp.async)
MapResult both(MapResult r0, MapResult r1) {
  if (r0 == kMapFailed || r1 == kMapFailed) return kMapFailed;
  return r0 == kMapped && r1 == kMapped ? kMapped : kNoMap;
}

// the cache's TMA maps, with boxes of one tile's TS slots, and Args::tma
// saying which segments they bring
template <bool MQA, typename KT, int DV>
MapResult encode_maps(Args& a, Maps& maps) {
  using C = Cfg<MQA, KT, DV>;
  constexpr long long esz = sizeof(KT);
  const long long slots = (long long)a.B * a.S;
  const int P = a.DK - DV;
  a.tma = 0;
  if (C::kBf16) {               // operand column blocks of 64, swizzled
    if (MQA) {
      const MapResult r = map_2d<KT>(&maps.k, a.k, DV, slots, esz * DV, 64, C::TS);
      if (r != kMapped) return r;
      a.tma = 1;
      if (P % 64 != 0) return r;  // the rope rows by cp.async
      const MapResult rv = map_2d<KT>(&maps.v, a.v, P, slots, esz * P, 64, C::TS);
      if (rv == kMapped) a.tma |= 2;
      return rv == kMapFailed ? rv : r;
    }
    if (a.DK % 64 != 0) return kNoMap;
    const MapResult r =
        both(map_2d<KT>(&maps.k, a.k, (long long)a.H * a.DK, slots, esz * a.H * a.DK, 64,
                        C::TS),
             map_2d<KT>(&maps.v, a.v, (long long)a.H * DV, slots, esz * a.H * DV, 64,
                        C::TS));
    if (r == kMapped) a.tma = 3;
    return r;
  }
  // int8, f16, f32: raw column blocks (raw_cw) of both segments
  const long long c0 = MQA ? DV : (long long)a.H * a.DK;
  const long long c1 = MQA ? P : (long long)a.H * DV;
  const int e0 = MQA ? DV : a.DK, e1 = MQA ? P : DV;
  if (e1 == 0) return kNoMap;
  const MapResult r = both(map_2d<KT>(&maps.k, a.k, c0, slots, esz * c0, raw_cw(e0), C::TS),
                           map_2d<KT>(&maps.v, a.v, c1, slots, esz * c1, raw_cw(e1), C::TS));
  if (r == kMapped) a.tma = 3;
  return r;
}

template <bool MQA, typename KT, int DV>
cudaError_t launch(Args a, int n_split, cudaStream_t stream) {
  using C = Cfg<MQA, KT, DV>;
  // the dynamic shared memory a block may take beside its static barriers
  static int max_dynamic = -1;
  if (max_dynamic < 0) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, prefill_attn_kernel<MQA, KT, DV>);
    if (err != cudaSuccess) return err;
    const int avail = kMaxSmem - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(prefill_attn_kernel<MQA, KT, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, avail);
    if (err != cudaSuccess) return err;
    max_dynamic = avail;
  }
  const int smem = layout<MQA, KT, DV>(a.DK).total;
  if (smem > max_dynamic) return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (encode_maps<MQA, KT, DV>(a, maps) == kMapFailed) return cudaErrorNotSupported;
  const int nx = MQA ? (a.T * a.H + C::BM - 1) / C::BM
                     : a.H * ((a.T + C::BM - 1) / C::BM);
  dim3 grid(nx, a.B, n_split);
  prefill_attn_kernel<MQA, KT, DV><<<grid, C::kThreads, smem, stream>>>(a, maps);
  return cudaGetLastError();
}

template <bool MQA, typename KT>
cudaError_t by_dv(const Args& a, int DV, int n_split, cudaStream_t stream) {
  switch (DV) {
    case 128: return launch<MQA, KT, 128>(a, n_split, stream);
    case 512: return launch<MQA, KT, 512>(a, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

int elem_size(int dtype) {
  switch (dtype) {
    case 0: return 4;
    case 1: case 2: return 2;
    case 3: return 1;
    default: return 0;
  }
}

// launch the template for `dtype`, then (n_split > 1) merge the splits'
// partials from scratch into out (and m_out, l_out)
template <bool MQA>
int run(Args a, int DV, int dtype, int n_split, float* scratch, float* out,
        float* m_out, float* l_out, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.T * a.H;
  if (n_split > 1) {
    a.out = scratch;
    a.m_out = scratch + n_split * rows * DV;
    a.l_out = a.m_out + n_split * rows;
  } else {
    a.out = out;
    a.m_out = m_out;
    a.l_out = l_out;
  }
  cudaError_t err;
  switch (dtype) {
    case 0: err = by_dv<MQA, float>(a, DV, n_split, stream); break;
    case 1: err = by_dv<MQA, __half>(a, DV, n_split, stream); break;
    case 2: err = by_dv<MQA, __nv_bfloat16>(a, DV, n_split, stream); break;
    case 3:
      if (a.ks == nullptr || a.vs == nullptr || a.sb < 0 || a.sh < 0 || a.ss < 0)
        return (int)cudaErrorInvalidValue;
      err = by_dv<MQA, int8_t>(a, DV, n_split, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_split == 1) return (int)err;
  merge_kernel<<<(unsigned)rows, kMergeThreads, 0, stream>>>(
      a.out, a.m_out, a.l_out, out, m_out, l_out, rows, DV, n_split);
  return (int)cudaGetLastError();
}

bool bad_dims(int B, int T, int H, int S, int DK, int DV, int dtype,
              int n_split, int span, const void* scratch, int max_splits = kMaxSplits) {
  return B <= 0 || B > 65535 || T <= 0 || H <= 0 || S <= 0 || DK <= 0 ||
         DK % 4 != 0 || (DV != 128 && DV != 512) || elem_size(dtype) == 0 ||
         n_split < 1 || n_split > max_splits || span <= 0 ||
         (n_split > 1 && scratch == nullptr) ||
         (long long)B * T * H > 2147483647LL - Cfg<true, float, 128>::BM;
}

}  // namespace

// K9: q (B,T,H,DK) f32, k (B,S,H,DK) and v (B,S,H,DV) of dtype 0 = f32,
// 1 = f16, 2 = bf16, 3 = int8 -> out (B,T,H,DV) f32. For int8, k_scale and
// v_scale are (B,H,S) f32 views with element strides (sb, sh, ss); ignored
// otherwise. DK % 4 == 0, DV in {128, 512}. With m_out and l_out (B,T,H)
// f32 (partials; both null otherwise) out is the unnormalized accumulator.
// The window is walked in n_split spans of `span` slots (n_split 1: span >=
// S); n_split > 1 needs f32 scratch of n_split * B*T*H * (DV + 2).
// Returns a cudaError_t; the launches are asynchronous on `stream`.
extern "C" int mha_prefill(const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale,
                           void* out, void* m_out, void* l_out, void* scratch,
                           int n_split, int span, int B, int T, int H, int S,
                           int DK, int DV, int dtype, int q_pos0,
                           int cache_pos0, float scale, int sb, int sh, int ss,
                           void* stream) {
  if (bad_dims(B, T, H, S, DK, DV, dtype, n_split, span, scratch) ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long esz = elem_size(dtype);
  Args a{static_cast<const float*>(q), nullptr, k, v, nullptr, nullptr, nullptr,
         B, T, H, S, DK, q_pos0, cache_pos0, scale, span,
         chunk_bytes(k, DK * esz, (long long)H * DK * esz),
         chunk_bytes(v, DV * esz, (long long)H * DV * esz), 0,
         static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         sb, sh, ss};
  return run<false>(a, DV, dtype, n_split, static_cast<float*>(scratch),
                    static_cast<float*>(out), static_cast<float*>(m_out),
                    static_cast<float*>(l_out), static_cast<cudaStream_t>(stream));
}

// K10: q_c (B,T,H,R) and q_rope (B,T,H,P) f32, ckv (B,S,R) and krope
// (B,S,P) of dtype 0/1/2/3 (3 = int8, then ckv_scale and krope_scale (B,S)
// f32, contiguous) -> out (B,T,H,R) f32. R in {128, 512},
// (R + P) % 4 == 0. With m_out and l_out (B,T,H) f32 (partials; both null
// otherwise) out is the unnormalized accumulator. n_split, span and
// scratch as mha_prefill's. Returns a cudaError_t; asynchronous on `stream`.
extern "C" int mla_prefill(const void* q_c, const void* q_rope,
                           const void* ckv, const void* krope,
                           const void* ckv_scale, const void* krope_scale,
                           void* out, void* m_out, void* l_out, void* scratch,
                           int n_split, int span, int B, int T, int H, int S,
                           int R, int P, int dtype, int q_pos0, int cache_pos0,
                           float scale, void* stream) {
  if (bad_dims(B, T, H, S, R + P, R, dtype, n_split, span, scratch) || P < 0 ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long esz = elem_size(dtype);
  Args a{static_cast<const float*>(q_c), static_cast<const float*>(q_rope),
         ckv, krope, nullptr, nullptr, nullptr, B, T, H, S, R + P, q_pos0,
         cache_pos0, scale, span, chunk_bytes(ckv, R * esz, R * esz),
         chunk_bytes(krope, P * esz, P * esz), 0,
         static_cast<const float*>(ckv_scale),
         static_cast<const float*>(krope_scale), S, 0, 1};
  return run<true>(a, R, dtype, n_split, static_cast<float*>(scratch),
                   static_cast<float*>(out), static_cast<float*>(m_out),
                   static_cast<float*>(l_out), static_cast<cudaStream_t>(stream));
}

// K3: q_c (B,H,R) and q_rope (B,H,P) f32, ckv (B,S,R) and krope (B,S,P) of
// dtype 0/1/2/3 (3 = int8, then ckv_scale and krope_scale (B,S) f32,
// contiguous), kv_len (B,) int32 on the device -> out (B,H,R) f32 over the
// slots s < kv_len[b]. R in {128, 512}, (R + P) % 4 == 0. With m_out and
// l_out (B,H) f32 (partials; both null otherwise) out is the unnormalized
// accumulator. The window is walked in n_split <= kMaxDecodeSplits spans of
// `span` slots (n_split > 1 needs f32 scratch of n_split * B*H * (R + 2)).
// Returns a cudaError_t; the launches are asynchronous on `stream`.
extern "C" int mla_decode(const void* q_c, const void* q_rope, const void* ckv,
                          const void* krope, const void* ckv_scale,
                          const void* krope_scale, const void* kv_len, void* out,
                          void* m_out, void* l_out, void* scratch, int n_split,
                          int span, int B, int H, int S, int R, int P, int dtype,
                          float scale, void* stream) {
  if (bad_dims(B, 1, H, S, R + P, R, dtype, n_split, span, scratch,
               kMaxDecodeSplits) ||
      P < 0 || kv_len == nullptr || (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long esz = elem_size(dtype);
  Args a{static_cast<const float*>(q_c), static_cast<const float*>(q_rope),
         ckv, krope, nullptr, nullptr, nullptr, B, 1, H, S, R + P, 0, 0, scale,
         span, chunk_bytes(ckv, R * esz, R * esz), chunk_bytes(krope, P * esz, P * esz),
         0, static_cast<const float*>(ckv_scale), static_cast<const float*>(krope_scale),
         S, 0, 1, static_cast<const int32_t*>(kv_len)};
  return run<true>(a, R, dtype, n_split, static_cast<float*>(scratch),
                   static_cast<float*>(out), static_cast<float*>(m_out),
                   static_cast<float*>(l_out), static_cast<cudaStream_t>(stream));
}
