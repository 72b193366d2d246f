// Decompressed-MHA flash decode for Hopper (sm_90a), split over the KV axis.
//
// Replaces the TPU kernel deepseek_tpu/ops/pallas/attention.py::
// mha_decode_attn (_mha_body, K8): per sequence b and head h,
//
//   s_t  = scale * q[b,h] . k[b,t,h],   t < kv_len[b] (later slots masked)
//   out  = sum_t softmax(s)_t * v[b,t,h]          (B, H, Dv) float32
//
// with the cache in its (B, S, H, D) layout: one slot's keys for all heads
// are contiguous (16 heads x 192 x 2 B = 6 KB in bf16 at V2-Lite width).
//
// Bound: bytes. At kv_len 4000, H = 16 the cache holds 41 MB and the work
// is ~41 MFLOP, about one flop per byte, far below the card's balance
// point, so the f32 FMAs on the CUDA cores are not the limit; the design is
// about keeping enough cache bytes in flight:
//  - the TPU walks S in order per (batch, head group); at B = 1, H = 16
//    that is one program, which would leave all but one of the 132 SMs
//    idle. Here the grid is (head group, KV split, sequence) with enough
//    splits for about two blocks per SM, each block runs the online softmax
//    over its slice and writes unnormalized partials (acc, m, l), and a
//    second kernel merges the splits exactly:
//      out = sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*);
//  - a block owns 16 heads (all of them at V2-Lite width) and a tile of 32
//    slots. Scores: a group of 8 lanes takes one (slot, head) row and reads
//    it in 16-byte vectors, so a warp instruction covers four 128-byte runs
//    of the cache; the four groups of a warp share the head and take four
//    slots, so their query reads from shared memory are broadcasts. Each
//    lane keeps 8 slots' loads in flight.
//  - values: thread i owns 16 bytes of one head's value row (16 heads x
//    128 values x 2 B = 4 KB a slot: one coalesced sweep of the block) and
//    keeps several slots' loads in flight.
// Slots at or past kv_len are never read (addresses clamp to the last live
// slot, their weights are 0).
//
// int8 cache (kv_cache_dtype="int8"): a 16-byte vector holds 16 values,
// and every (slot, head) key and value row has an f32 scale (amax/127),
// read from the head-major (B,H,S) scale views through their strides (the
// cache keeps them (B,S,H); the transposed view costs no copy). As on the
// TPU the scales fold into the scores and the weights:
//   s_t = scale * (q . k8[t]) * ks[t],   acc += (p_t * vs[t]) * v8[t],
// with l summing the unscaled p_t. The cache bytes are half the f16
// cache's, plus 8 bytes a (slot, head).
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

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kHG = 16;         // heads per block (warp w: softmax of w, w+8)
constexpr int kTS = 32;         // cache slots per tile (one per lane)
constexpr int kGL = 8;          // lanes per (slot, head) dot product
constexpr int kSlotsPerGroup = kTS / 4;   // 4 groups of 8 lanes a warp
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;      // head_dim and v_head_dim limit
constexpr int kMaxSplits = 256; // the merge keeps one weight per split

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// VJ: 16-byte value vectors owned per thread (kHG * Dv / VE <= VJ * 256)
template <typename T, int VJ>
__global__ void __launch_bounds__(kThreads)
mha_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs,
                 const int32_t* __restrict__ kv_len,
                 float* __restrict__ acc_out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int S, int Dh, int Dv,
                 int chunk, int nsplit, float scale, int sb, int sh, int ss) {
  constexpr int VE = 16 / sizeof(T);          // cache elements per vector
  constexpr bool kQ = std::is_same<T, int8_t>::value;   // int8 rows + scales
  constexpr int kVU = 8 / VJ;                 // value slots loaded at once
  __shared__ __align__(16) float qs[kHG * kMaxD];   // [kHG][Dh]
  __shared__ float ps[kTS][kHG + 1];                // scores, then weights
  __shared__ float alpha_s[kHG];

  const int hg = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int h_base = hg * kHG;
  const int nh = min(kHG, H - h_base);        // live heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = lane >> 3, gl = lane & (kGL - 1);
  const int len = min(kv_len[b], S);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const size_t part = ((size_t)b * H + h_base) * nsplit + split;  // (b,h,split)

  if (start >= end) {          // empty slice: l = 0 tells the merge to skip
    if (tid < nh) {
      m_out[part + (size_t)tid * nsplit] = kNegInf;
      l_out[part + (size_t)tid * nsplit] = 0.f;
    }
    return;
  }

  // the block's queries in f32; dead heads (past H) read as 0
  for (int i = tid; i < kHG * Dh; i += kThreads) {
    const int h = i / Dh;
    qs[i] = h < nh ? q[((size_t)b * H + h_base + h) * Dh + (i - h * Dh)] : 0.f;
  }

  const size_t kslot = (size_t)H * Dh, vslot = (size_t)H * Dv;
  const T* kb = k + (size_t)b * S * kslot + (size_t)h_base * Dh;
  const T* vb = v + (size_t)b * S * vslot + (size_t)h_base * Dv;
  const int nvk = Dh / VE, nvv = Dv / VE;
  // int8: the scale of (slot t, block head h) is sc_b[h * sh + t * ss]
  const size_t sc_b = (size_t)b * sb + (size_t)h_base * sh;

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // heads warp, warp+8
  float acc[VJ][VE];
#pragma unroll
  for (int j = 0; j < VJ; ++j)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[j][e] = 0.f;

  for (int t0 = start; t0 < end; t0 += kTS) {
    __syncthreads();           // qs staged / the previous tile's weights used
    // scores: the group (gw) of 8 lanes takes slots t0 + gw + 4i of head h
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = warp + 8 * hh;
      const int hc = min(h, nh - 1);          // dead heads read a live row
      const float* qh = qs + h * Dh;
      float sc[kSlotsPerGroup];
#pragma unroll
      for (int i = 0; i < kSlotsPerGroup; ++i) sc[i] = 0.f;
      for (int vi = gl; vi < nvk; vi += kGL) {
        uint4 raw[kSlotsPerGroup];
#pragma unroll
        for (int i = 0; i < kSlotsPerGroup; ++i) {
          const int pos = min(t0 + gw + 4 * i, end - 1);   // clamped: in bounds
          raw[i] = __ldg(reinterpret_cast<const uint4*>(
              kb + (size_t)pos * kslot + (size_t)hc * Dh) + vi);
        }
        float qv[VE];
#pragma unroll
        for (int e = 0; e < VE; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(qh + vi * VE + e);
          qv[e] = f.x; qv[e + 1] = f.y; qv[e + 2] = f.z; qv[e + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < kSlotsPerGroup; ++i) {
          float kv[VE];
          widen<T>(raw[i], kv);
#pragma unroll
          for (int e = 0; e < VE; ++e) sc[i] = fmaf(qv[e], kv[e], sc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerGroup; ++i) {
#pragma unroll
        for (int m = kGL / 2; m > 0; m >>= 1)
          sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], m);
      }
      if (gl == 0) {
#pragma unroll
        for (int i = 0; i < kSlotsPerGroup; ++i) {
          if constexpr (kQ) {
            const int pos = min(t0 + gw + 4 * i, end - 1);
            sc[i] *= ks[sc_b + (size_t)hc * sh + (size_t)pos * ss];
          }
          ps[gw + 4 * i][h] = sc[i];
        }
      }
    }
    __syncthreads();

    // online softmax: warp w keeps (m, l) of heads w and w + 8, lane = slot
    {
      const bool valid = t0 + lane < end;
      const float s0 = valid ? ps[lane][warp] * scale : kNegInf;
      const float s1 = valid ? ps[lane][warp + 8] * scale : kNegInf;
      const float mn0 = fmaxf(m0, warp_max(s0));
      const float mn1 = fmaxf(m1, warp_max(s1));
      const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
      const float p0 = valid ? __expf(s0 - mn0) : 0.f;
      const float p1 = valid ? __expf(s1 - mn1) : 0.f;
      l0 = l0 * al0 + warp_sum(p0);
      l1 = l1 * al1 + warp_sum(p1);
      m0 = mn0;
      m1 = mn1;
      ps[lane][warp] = p0;
      ps[lane][warp + 8] = p1;
      if (lane == 0) {
        alpha_s[warp] = al0;
        alpha_s[warp + 8] = al1;
      }
    }
    __syncthreads();

    // acc[h][c] = acc * alpha[h] + sum_t p[t][h] * v[t][h][c]
    const int ntile = min(kTS, end - t0);
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < kHG * nvv) {
        const float a = alpha_s[idx / nvv];
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[j][e] *= a;
      }
    }
    for (int t = 0; t < ntile; t += kVU) {
      uint4 raw[kVU][VJ];
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        const int pos = t0 + min(t + u, ntile - 1);     // clamped: live slot
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const int idx = min(tid + j * kThreads, kHG * nvv - 1);
          const int hl = min(idx / nvv, nh - 1), cv = idx % nvv;
          raw[u][j] = __ldg(reinterpret_cast<const uint4*>(
              vb + (size_t)pos * vslot + (size_t)hl * Dv) + cv);
        }
      }
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        if (t + u >= ntile) break;
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const int idx = tid + j * kThreads;
          if (idx >= kHG * nvv) continue;
          float p = ps[t + u][idx / nvv];
          if constexpr (kQ)
            p *= vs[sc_b + (size_t)min(idx / nvv, nh - 1) * sh +
                    (size_t)(t0 + t + u) * ss];
          float w[VE];
          widen<T>(raw[u][j], w);
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[j][e] = fmaf(p, w[e], acc[j][e]);
        }
      }
    }
  }

  if (lane == 0) {
    if (warp < nh) {
      m_out[part + (size_t)warp * nsplit] = m0;
      l_out[part + (size_t)warp * nsplit] = l0;
    }
    if (warp + 8 < nh) {
      m_out[part + (size_t)(warp + 8) * nsplit] = m1;
      l_out[part + (size_t)(warp + 8) * nsplit] = l1;
    }
  }
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= kHG * nvv) continue;
    const int hl = idx / nvv, cv = idx % nvv;
    if (hl >= nh) continue;
    float* dst = acc_out + (part + (size_t)hl * nsplit) * Dv + cv * VE;
#pragma unroll
    for (int e = 0; e < VE; ++e) dst[e] = acc[j][e];
  }
}

// one block per (b, h): exact merge of the split partials. The block
// reduces m* = max_s m_s and sum_s l_s e^(m_s - m*) over the splits in
// parallel (a split per thread) and keeps each split's weight e^(m_s - m*)
// in shared memory, 0 for an empty split (l = 0), whose partials were
// never written and are not read. With m_out (partials) the sum is not
// divided and the block writes m* and l* (-1e30 and 0 with no live split).
constexpr int kMergeThreads = 128;

__global__ void __launch_bounds__(kMergeThreads)
mha_merge_kernel(const float* __restrict__ acc_in, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Dv,
                 int nsplit) {
  constexpr int kWarps = kMergeThreads / 32;
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[2][kWarps];
  const size_t bh = blockIdx.x;
  const float* m = m_in + bh * nsplit;
  const float* l = l_in + bh * nsplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float mx = kNegInf;
  for (int s = tid; s < nsplit; s += kMergeThreads)
    if (l[s] > 0.f) mx = fmaxf(mx, m[s]);
  mx = warp_max(mx);
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  mx = red[0][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[0][w]);

  float den = 0.f;
  for (int s = tid; s < nsplit; s += kMergeThreads) {
    const float ls = l[s];
    const float e = ls > 0.f ? __expf(m[s] - mx) : 0.f;
    w_s[s] = e;
    den += ls * e;
  }
  den = warp_sum(den);
  if (lane == 0) red[1][warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) den += red[1][w];
  const float inv = m_out != nullptr ? 1.f : (den > 0.f ? 1.f / den : 0.f);
  if (m_out != nullptr && tid == 0) {
    m_out[bh] = mx;              // kNegInf when no split is live
    l_out[bh] = den;
  }

  const float* acc = acc_in + bh * nsplit * Dv;
  for (int col = tid; col < Dv; col += kMergeThreads) {
    float r = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const float w = w_s[s];
      if (w != 0.f) r = fmaf(acc[(size_t)s * Dv + col], w, r);
    }
    out[bh * Dv + col] = r * inv;
  }
}

struct Scales {
  const float* k;   // (B,H,S) f32 views of int8 caches, null otherwise
  const float* v;
  int sb, sh, ss;   // their element strides (the same for both)
};

template <typename T, int VJ>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const Scales& sc, const int32_t* kv_len, float* out,
                   float* m_out, float* l_out, float* acc, float* m, float* l,
                   int B, int H, int S, int Dh, int Dv, int nsplit, float scale,
                   cudaStream_t stream) {
  const int chunk = ((S + nsplit - 1) / nsplit + kTS - 1) / kTS * kTS;
  dim3 grid((H + kHG - 1) / kHG, nsplit, B);
  mha_split_kernel<T, VJ><<<grid, kThreads, 0, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), sc.k, sc.v, kv_len,
      acc, m, l, H, S, Dh, Dv, chunk, nsplit, scale, sc.sb, sc.sh, sc.ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_merge_kernel<<<B * H, kMergeThreads, 0, stream>>>(acc, m, l, out, m_out,
                                                        l_out, Dv, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* q, const void* k, const void* v,
                     const Scales& sc, const int32_t* kv_len, float* out,
                     float* m_out, float* l_out, float* acc, float* m, float* l,
                     int B, int H, int S, int Dh, int Dv, int nsplit,
                     float scale, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  if (Dh % VE || Dv % VE) return cudaErrorInvalidValue;
  const int vecs = kHG * (Dv / VE);
  if (vecs <= kThreads)
    return launch<T, 1>(q, k, v, sc, kv_len, out, m_out, l_out, acc, m, l, B,
                        H, S, Dh, Dv, nsplit, scale, stream);
  if (vecs <= 2 * kThreads)
    return launch<T, 2>(q, k, v, sc, kv_len, out, m_out, l_out, acc, m, l, B,
                        H, S, Dh, Dv, nsplit, scale, stream);
  return launch<T, 4>(q, k, v, sc, kv_len, out, m_out, l_out, acc, m, l, B, H,
                      S, Dh, Dv, nsplit, scale, stream);
}

}  // namespace

// q (B,H,Dh) f32, k (B,S,H,Dh) and v (B,S,H,Dv) of dtype 0 = f32, 1 = f16,
// 2 = bf16, 3 = int8 (contiguous, 16-byte aligned), kv_len (B,) int32 ->
// out (B,H,Dv) f32. With m_out and l_out (B,H) f32 (partials; both null
// otherwise) out is the unnormalized accumulator and m_out, l_out its flash
// statistics. For int8, k_scale and v_scale are (B,H,S) f32 views
// with element strides (sb, sh, ss); ignored otherwise. acc
// (B,H,nsplit,Dv), m and l (B,H,nsplit) f32 are scratch the caller
// allocates. Needs Dh, Dv <= 256, each a whole number of 16-byte vectors,
// and at most 256 splits (checked here).
// Returns a cudaError_t; both launches are asynchronous on `stream`.
extern "C" int mha_decode(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* kv_len, void* out, void* m_out,
                          void* l_out, void* acc, void* m, void* l, int B,
                          int H, int S, int Dh, int Dv, int dtype, int nsplit,
                          float scale, int sb, int sh, int ss, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || Dh <= 0 || Dh > kMaxD ||
      Dv <= 0 || Dv > kMaxD || nsplit <= 0 || nsplit > kMaxSplits ||
      nsplit > 65535 || (m_out == nullptr) != (l_out == nullptr) ||
      (dtype == 3 && (k_scale == nullptr || v_scale == nullptr || sb < 0 ||
                      sh < 0 || ss < 0)))
    return (int)cudaErrorInvalidValue;
  const Scales sc{static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale), sb, sh, ss};
  auto qq = static_cast<const float*>(q);
  auto kl = static_cast<const int32_t*>(kv_len);
  auto o = static_cast<float*>(out);
  auto mo = static_cast<float*>(m_out);
  auto lo = static_cast<float*>(l_out);
  auto ac = static_cast<float*>(acc);
  auto mm = static_cast<float*>(m);
  auto ll = static_cast<float*>(l);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(qq, k, v, sc, kl, o, mo, lo, ac, mm, ll, B, H,
                                  S, Dh, Dv, nsplit, scale, st);
    case 1:
      return (int)dispatch<__half>(qq, k, v, sc, kl, o, mo, lo, ac, mm, ll, B,
                                   H, S, Dh, Dv, nsplit, scale, st);
    case 2:
      return (int)dispatch<__nv_bfloat16>(qq, k, v, sc, kl, o, mo, lo, ac, mm,
                                          ll, B, H, S, Dh, Dv, nsplit, scale,
                                          st);
    case 3:
      return (int)dispatch<int8_t>(qq, k, v, sc, kl, o, mo, lo, ac, mm, ll, B,
                                   H, S, Dh, Dv, nsplit, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
