// Decompressed-MHA flash decode for Hopper (sm_90a), split over the KV axis.
//
// Replaces the TPU kernel deepseek_tpu/ops/pallas/attention.py::
// mha_decode_attn (_mha_body, K8): per sequence b and head h,
//
//   s_t  = scale * q[b,h] . k[b,t,h],   t < kv_len[b] (later slots masked)
//   out  = sum_t softmax(s)_t * v[b,t,h]          (B, H, Dv) float32
//
// with the cache in its (B, S, H, D) layout: one slot's keys for a run of
// heads are contiguous (16 heads x 192 x 2 B = 6 KB in bf16 at V2-Lite
// width, its values 4 KB).
//
// Bound: bytes. At kv_len 4000, H = 16 the cache holds 41 MB and the work
// is ~41 MFLOP, about one flop per byte, far below the card's balance
// point; the f32 FMAs on the CUDA cores are not the limit. The design is
// about keeping the cache streaming, so enough bytes are in flight on
// every SM from the first cycle to the last:
//  - the grid is (head group, KV split, sequence); a block owns 8 heads
//    (a warp each) and one split of `span` slots (a pure function of the
//    shapes, ops/kernels/attention.py::decode_splits, about two blocks an
//    SM), and walks it in tiles of TS slots (8 for int8, 4 otherwise);
//  - the tiles come by 1-D bulk copies (cp.async.bulk, TMA without a
//    tensor map) into a ring of NS stages, an mbarrier a stage, as deep as
//    ~100 KB of shared memory allows (int8 and bf16 at V2-Lite width: 5
//    stages of 20 KB): one thread asks for the keys and values of every
//    slot of a tile, one copy each (one for the whole tile where the block
//    holds every head: the run is contiguous), and refills a stage as soon
//    as the block has used it, so a block has NS tiles in flight while it
//    computes;
//  - a warp works its head alone, with no barrier inside a tile: scores
//    with 32/TS lanes a slot (16-byte vectors of the key row against q in
//    registers, shuffle sums), the online softmax over the tile's slots
//    (shuffles, fast exp), then the values, a 16-byte vector of the value
//    row a lane (the lanes split the slots where the row is narrower than
//    the warp); one __syncthreads a tile frees its stage;
//  - each block writes unnormalized partials (acc, m, l) and a second
//    kernel merges the splits exactly:
//      out = sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*).
// Slots at or past kv_len are never copied; their scores and weights are
// masked, and the values of dead slots of a tile are not read.
//
// int8 cache (kv_cache_dtype="int8"): a 16-byte vector holds 16 values,
// and every (slot, head) key and value row has an f32 scale (amax/127),
// read from the head-major (B,H,S) scale views through their strides (the
// cache keeps them (B,S,H); the transposed view costs no copy). As on the
// TPU the scales fold into the scores and the weights:
//   s_t = scale * (q . k8[t]) * ks[t],   acc += (p_t * vs[t]) * v8[t],
// with l summing the unscaled p_t. The cache bytes are half the bf16
// cache's, plus 8 bytes a (slot, head); a lane loads its slot's scales a
// tile ahead, so their latency hides behind a tile's products.
//
// Partials (partials=True, the sequence-parallel decode: one shard of the
// window per rank): the merge writes one unnormalized triple per (b, h),
//   m = max_s m_s,  l = sum_s l_s e^(m_s - m),  acc = sum_s acc_s e^(m_s - m),
// the TPU kernel's partials output. A shard past the live prefix (kv_len
// 0: every split empty) gives acc 0, l 0 and m = -1e30 (the JAX _NEG_INF).
// An int8 shard's scales are the (B,H,S) view of the shard's own slice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps, a head each
constexpr int kHG = 8;           // heads a block (_MHA_HEADS in the wrapper)
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;       // head_dim and v_head_dim limit
constexpr int kMaxSplits = 256;  // the merge keeps one weight per split
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 104 * 1024;   // two blocks an SM
constexpr int kMaxSmem = 232448;

template <typename T>
struct Cfg {
  static constexpr int VE = 16 / (int)sizeof(T);        // values a 16-byte vector
  static constexpr int TS = sizeof(T) == 1 ? 8 : 4;     // slots a tile
  static constexpr int LPS = 32 / TS;                   // lanes a key row
  static constexpr int KV = kMaxD / VE / LPS;           // key vectors a lane, at most
  static constexpr int VJ = kMaxD / VE > 32 ? 2 : 1;    // value vectors a lane, at most
};

template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* out);

template <>
__device__ __forceinline__ void widen<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

template <>
__device__ __forceinline__ void widen<int8_t>(const uint4& v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = static_cast<float>(static_cast<int8_t>((u[i] >> (8 * j)) & 0xFFu));
}

template <>
__device__ __forceinline__ void widen<__half>(const uint4& v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

struct Args {
  const float* q;            // (B,H,Dh) f32
  const void* k;             // (B,S,H,Dh)
  const void* v;             // (B,S,H,Dv)
  const float* ks;           // int8: (B,H,S) scale views, element strides
  const float* vs;           // (sb, sh, ss); null otherwise
  const int32_t* kv_len;     // (B,)
  float* acc;                // (B,H,nsplit,Dv) split partials
  float* m;                  // (B,H,nsplit)
  float* l;
  int H, S, Dh, Dv, span, nsplit, ns;   // ns: ring stages
  float scale;
  int sb, sh, ss;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mha_split_kernel(Args a) {
  using C = Cfg<T>;
  constexpr int VE = C::VE, TS = C::TS, LPS = C::LPS;
  constexpr bool kQ = std::is_same<T, int8_t>::value;   // int8 rows + scales
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];

  const int hg = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int h_base = hg * kHG;
  const int nh = min(kHG, a.H - h_base);       // live heads of this block
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int len = min(a.kv_len[b], a.S);
  const int start = split * a.span;
  const int end = min(start + a.span, len);
  const size_t part = ((size_t)b * a.H + h_base) * a.nsplit + split;   // (b,h,split)

  if (start >= end) {          // empty slice: l = 0 tells the merge to skip
    if (tid < nh) {
      a.m[part + (size_t)tid * a.nsplit] = kNegInf;
      a.l[part + (size_t)tid * a.nsplit] = 0.f;
    }
    return;
  }

  const int ntiles = (end - start + TS - 1) / TS;
  const int kb = nh * a.Dh * (int)sizeof(T);            // key bytes a slot
  const int vb = nh * a.Dv * (int)sizeof(T);            // value bytes a slot
  const int stage_b = TS * (kb + vb);                   // keys, then values
  const size_t kslot = (size_t)a.H * a.Dh * sizeof(T);  // bytes between slots
  const size_t vslot = (size_t)a.H * a.Dv * sizeof(T);
  const char* kg = static_cast<const char*>(a.k) +
                   (size_t)b * a.S * kslot + (size_t)h_base * a.Dh * sizeof(T);
  const char* vg = static_cast<const char*>(a.v) +
                   (size_t)b * a.S * vslot + (size_t)h_base * a.Dv * sizeof(T);
  const uint32_t ring_a = smem_addr(ring);

  if (tid == 0) {
    for (int s = 0; s < a.ns; ++s) mbar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one thread asks for tile i: its live slots' keys and values, one bulk
  // copy each (one for all slots where the block holds every head)
  auto issue = [&](int i) {
    const int st = i % a.ns;
    const int t0 = start + i * TS, nt = min(TS, end - t0);
    const uint32_t bar = smem_addr(&bars[st]);
    const uint32_t dk = ring_a + st * stage_b, dv = dk + TS * kb;
    mbar_expect(bar, nt * (kb + vb));
    if (nh == a.H) {
      bulk_1d(dk, kg + (size_t)t0 * kslot, nt * kb, bar);
      bulk_1d(dv, vg + (size_t)t0 * vslot, nt * vb, bar);
    } else {
      for (int t = 0; t < nt; ++t) {
        bulk_1d(dk + t * kb, kg + (size_t)(t0 + t) * kslot, kb, bar);
        bulk_1d(dv + t * vb, vg + (size_t)(t0 + t) * vslot, vb, bar);
      }
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(a.ns, ntiles); ++i) issue(i);

  // keys: lane = (slot sl, part sub), vectors sub + LPS*i of the key row;
  // q's matching values in registers
  const int sl = lane / LPS, sub = lane % LPS;
  const int nvk = a.Dh / VE;
  float qv[C::KV][VE];
  const int hq = min(w, nh - 1);             // dead warps read a live row
  const float* qh = a.q + ((size_t)b * a.H + h_base + hq) * a.Dh;
#pragma unroll
  for (int i = 0; i < C::KV; ++i) {
    const int vi = sub + LPS * i;
#pragma unroll
    for (int e = 0; e < VE; e += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vi < nvk) f = *reinterpret_cast<const float4*>(qh + vi * VE + e);
      qv[i][e] = f.x; qv[i][e + 1] = f.y; qv[i][e + 2] = f.z; qv[i][e + 3] = f.w;
    }
  }
  // values: vector j of the value row; where the row has fewer vectors
  // than a power-of-two share of the warp, the lanes split the slots into
  // P phases (lane = phase * nvv + j) and sum the phases at the end
  const int nvv = a.Dv / VE;
  const int P = (nvv < 32 && (32 % nvv) == 0) ? 32 / nvv : 1;
  const int ph = P > 1 ? lane / nvv : 0;
  const int vj = P > 1 ? lane % nvv : lane;
  // int8 scales of (slot, this head): ks_h[t * ss]
  const size_t sc_h = (size_t)b * a.sb + (size_t)(h_base + hq) * a.sh;

  // int8: this lane's slot's scales, the next tile's loaded a tile ahead
  auto scales = [&](int i, float& kd, float& vd) {
    if constexpr (kQ) {
      const int t0 = start + i * TS;
      const size_t at = sc_h + (size_t)(t0 + min(sl, end - 1 - t0)) * a.ss;
      kd = a.ks[at];
      vd = a.vs[at];
    }
  };
  float ksc = 1.f, vsc = 1.f, ksc_n = 1.f, vsc_n = 1.f;
  if (w < nh) scales(0, ksc, vsc);

  float m = kNegInf, l = 0.f;
  float acc[C::VJ][VE];
#pragma unroll
  for (int j = 0; j < C::VJ; ++j)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % a.ns;
    const int t0 = start + i * TS, nt = min(TS, end - t0);
    if (w < nh) {
      if (i + 1 < ntiles) scales(i + 1, ksc_n, vsc_n);
      mbar_wait(smem_addr(&bars[st]), (i / a.ns) & 1);
      const uint8_t* kt = ring + st * stage_b;
      const uint8_t* vt = kt + TS * kb;
      // scores
      const uint8_t* krow = kt + (size_t)sl * kb + (size_t)w * a.Dh * sizeof(T);
      float sc = 0.f;
#pragma unroll
      for (int ii = 0; ii < C::KV; ++ii) {
        const int vi = sub + LPS * ii;
        if (vi < nvk) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + vi * 16);
          float kv[VE];
          widen<T>(raw, kv);
#pragma unroll
          for (int e = 0; e < VE; ++e) sc = fmaf(qv[ii][e], kv[e], sc);
        }
      }
#pragma unroll
      for (int o = LPS / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      const bool live = sl < nt;
      const float s = live ? sc * ksc * a.scale : kNegInf;
      // online softmax over the tile's slots (one value a slot group)
      float mt = s;
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m, mt);
      const float alpha = __expf(m - mn);
      const float p = live ? __expf(s - mn) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l = l * alpha + ps;
      m = mn;
      const float pv = p * vsc;                 // the weight of this lane's slot
#pragma unroll
      for (int j = 0; j < C::VJ; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[j][e] *= alpha;
      // values: slots ph, ph + P, ... of the tile
      const uint8_t* vrow = vt + (size_t)w * a.Dv * sizeof(T);
#pragma unroll
      for (int u = 0; u < TS; ++u) {
        const int t = ph + P * u;
        if (P * u >= TS) break;
        const float pt = __shfl_sync(0xffffffffu, pv, min(t, TS - 1) * LPS);
        if (t < nt) {
#pragma unroll
          for (int j = 0; j < C::VJ; ++j) {
            const int vv = vj + 32 * j;
            if (vv < nvv) {
              const uint4 raw =
                  *reinterpret_cast<const uint4*>(vrow + (size_t)t * vb + vv * 16);
              float x[VE];
              widen<T>(raw, x);
#pragma unroll
              for (int e = 0; e < VE; ++e) acc[j][e] = fmaf(pt, x[e], acc[j][e]);
            }
          }
        }
      }
      ksc = ksc_n;
      vsc = vsc_n;
    }
    __syncthreads();                            // stage st used by every warp
    if (tid == 0 && i + a.ns < ntiles) issue(i + a.ns);
  }

  if (w >= nh) return;
  // the phases' sums of the same vectors
  for (int o = nvv; o < 32 && P > 1; o <<= 1)
#pragma unroll
    for (int j = 0; j < C::VJ; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
  const size_t row = part + (size_t)w * a.nsplit;
  if (lane == 0) {
    a.m[row] = m;
    a.l[row] = l;
  }
  if (ph != 0) return;
#pragma unroll
  for (int j = 0; j < C::VJ; ++j) {
    const int vv = vj + 32 * j;
    if (vv >= nvv) continue;
    float* dst = a.acc + row * a.Dv + vv * VE;
#pragma unroll
    for (int e = 0; e < VE; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
  }
}

// one block per (b, h): exact merge of the split partials. Groups of
// threads, each a whole row of Dv values in float4s, take every G-th
// split and fold it into their own (m, l, acc) as the online softmax does
// (an empty split, l = 0, whose row was never written, is skipped); the
// loads of kMergeBatch splits are issued before any is used, so one round
// trip to L2 serves them. The groups' triples then combine through shared memory.
// With m_out (partials) the sum is not divided and the block writes m* and
// l* (-1e30 and 0 with no live split).
constexpr int kMergeThreads = 512;
constexpr int kMergeBatch = 4;
static_assert(kMaxSplits <= kMergeThreads, "a split a thread at least");

__global__ void __launch_bounds__(kMergeThreads)
mha_merge_kernel(const float* __restrict__ acc_in, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Dv,
                 int nsplit) {
  __shared__ float gm[kMergeThreads], gl[kMergeThreads];
  __shared__ __align__(16) float gacc[kMergeThreads * 4];     // [G][Dv]
  const size_t bh = blockIdx.x;
  const float* m = m_in + bh * nsplit;
  const float* l = l_in + bh * nsplit;
  const float* acc = acc_in + bh * nsplit * Dv;
  const int tid = threadIdx.x;
  const int nc4 = Dv / 4;                 // float4s a row (Dv % 4 == 0)
  const int G = kMergeThreads / nc4;      // groups of a row's threads
  const int c4 = tid % nc4, grp = tid / nc4;

  float mt = kNegInf, lt = 0.f;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < G) {
    for (int s0 = grp; s0 < nsplit; s0 += kMergeBatch * G) {
      float ms[kMergeBatch], ls[kMergeBatch];
      float4 as[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int s = min(s0 + j * G, nsplit - 1);
        ms[j] = m[s];
        ls[j] = s0 + j * G < nsplit ? l[s] : 0.f;
        as[j] = *reinterpret_cast<const float4*>(acc + (size_t)s * Dv + c4 * 4);
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        if (ls[j] > 0.f) {
          const float mn = fmaxf(mt, ms[j]);
          const float ea = __expf(mt - mn), eb = __expf(ms[j] - mn);
          lt = lt * ea + ls[j] * eb;
          r.x = r.x * ea + as[j].x * eb; r.y = r.y * ea + as[j].y * eb;
          r.z = r.z * ea + as[j].z * eb; r.w = r.w * ea + as[j].w * eb;
          mt = mn;
        }
      }
    }
    if (c4 == 0) {
      gm[grp] = mt;
      gl[grp] = lt;
    }
    *reinterpret_cast<float4*>(gacc + grp * Dv + c4 * 4) = r;
  }
  __syncthreads();
  float mx = kNegInf;
  for (int g = 0; g < G; ++g)
    if (gl[g] > 0.f) mx = fmaxf(mx, gm[g]);
  float den = 0.f;
  for (int g = 0; g < G; ++g)
    if (gl[g] > 0.f) den += gl[g] * __expf(gm[g] - mx);
  if (m_out != nullptr && tid == 0) {
    m_out[bh] = mx;              // kNegInf when no split is live
    l_out[bh] = den;
  }
  const float inv = m_out != nullptr ? 1.f : (den > 0.f ? 1.f / den : 0.f);
  for (int col = tid; col < Dv; col += kMergeThreads) {
    float t = 0.f;
    for (int g = 0; g < G; ++g)
      if (gl[g] > 0.f) t += gacc[g * Dv + col] * __expf(gm[g] - mx);
    out[bh * Dv + col] = t * inv;
  }
}

template <typename T>
cudaError_t launch(Args a, int B, float* out, float* m_out, float* l_out,
                   cudaStream_t stream) {
  using C = Cfg<T>;
  constexpr int VE = C::VE;
  if (a.Dh % VE || a.Dv % VE) return cudaErrorInvalidValue;
  // the ring: as many stages as kRingBytes holds, at least two
  const int nh = min(kHG, a.H);
  const int stage_b = C::TS * nh * (a.Dh + a.Dv) * (int)sizeof(T);
  a.ns = max(2, min(kMaxStages, kRingBytes / stage_b));
  const int smem = a.ns * stage_b;
  static int max_dynamic = -1;
  if (max_dynamic < 0) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, mha_split_kernel<T>);
    if (err != cudaSuccess) return err;
    const int avail = kMaxSmem - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(mha_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, avail);
    if (err != cudaSuccess) return err;
    max_dynamic = avail;
  }
  if (smem > max_dynamic) return cudaErrorInvalidValue;
  dim3 grid((a.H + kHG - 1) / kHG, a.nsplit, B);
  mha_split_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_merge_kernel<<<B * a.H, kMergeThreads, 0, stream>>>(a.acc, a.m, a.l, out, m_out,
                                                          l_out, a.Dv, a.nsplit);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,Dh) f32, k (B,S,H,Dh) and v (B,S,H,Dv) of dtype 0 = f32, 1 = f16,
// 2 = bf16, 3 = int8 (contiguous, 16-byte aligned), kv_len (B,) int32 ->
// out (B,H,Dv) f32. With m_out and l_out (B,H) f32 (partials; both null
// otherwise) out is the unnormalized accumulator and m_out, l_out its flash
// statistics. For int8, k_scale and v_scale are (B,H,S) f32 views
// with element strides (sb, sh, ss); ignored otherwise. The window is cut
// into nsplit splits of `span` slots (span a multiple of 8, nsplit * span
// >= S); acc (B,H,nsplit,Dv), m and l (B,H,nsplit) f32 are scratch the
// caller allocates. Needs Dh, Dv <= 256, each a whole number of 16-byte
// vectors, and at most 256 splits (checked here).
// Returns a cudaError_t; both launches are asynchronous on `stream`.
extern "C" int mha_decode(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* kv_len, void* out, void* m_out,
                          void* l_out, void* acc, void* m, void* l, int B,
                          int H, int S, int Dh, int Dv, int dtype, int nsplit,
                          int span, float scale, int sb, int sh, int ss,
                          void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || Dh <= 0 || Dh > kMaxD ||
      Dv <= 0 || Dv > kMaxD || nsplit <= 0 || nsplit > kMaxSplits ||
      span <= 0 || span % 8 || (long long)nsplit * span < S ||
      (m_out == nullptr) != (l_out == nullptr) ||
      (dtype == 3 && (k_scale == nullptr || v_scale == nullptr || sb < 0 ||
                      sh < 0 || ss < 0)))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale), static_cast<const int32_t*>(kv_len),
         static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
         H, S, Dh, Dv, span, nsplit, 0, scale, sb, sh, ss};
  auto o = static_cast<float*>(out);
  auto mo = static_cast<float*>(m_out);
  auto lo = static_cast<float*>(l_out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(a, B, o, mo, lo, st);
    case 1: return (int)launch<__half>(a, B, o, mo, lo, st);
    case 2: return (int)launch<__nv_bfloat16>(a, B, o, mo, lo, st);
    case 3: return (int)launch<int8_t>(a, B, o, mo, lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
